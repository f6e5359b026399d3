"""CPU golden reference (the port's copy of
``fractalrenderer_tpu/reference``)."""

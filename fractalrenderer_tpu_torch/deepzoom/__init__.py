"""Deep-zoom host side: HP math, reference orbits, the series skip and the
zoom-state manager with its preset zoom paths (the port's own copies of
the framework-free modules of ``fractalrenderer_tpu/deepzoom``, under the
same names)."""

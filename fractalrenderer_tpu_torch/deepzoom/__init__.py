"""Deep-zoom host side: HP math, reference orbits and the series skip (the
port's own copies of the framework-free modules of
``fractalrenderer_tpu/deepzoom``, under the same names).  The zoom-state
manager (``manager.py``) is not ported yet (ROADMAP Queue 1 item 6)."""

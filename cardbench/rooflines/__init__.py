"""The least time of a function of the engine, one module each, named by
the function a kernel mapping (``kernels/<kernel>.json``) gives."""

"""The JAX package's worked examples, on the card.

Each module runs as ``python -m bbcat_dsp_torch.examples.<name>`` and
refuses to run without a CUDA device; ``main(..., device="cpu")`` runs it
on the CPU.  Its sizes are arguments of ``main``, whose defaults are the
JAX example's, and it checks its own result:

- ``fit_ir``: recover an IR by gradient descent through the convolver's
  kernels (``examples/fit_ir.py``);
- ``doppler``: a source closing on the listener through the fractional
  delay line, and the same shift through the resampler
  (``examples/doppler.py``);
- ``streaming_eq``: a three-stage EQ retargeted live without a click
  (``examples/streaming_eq.py``);
- ``binaural_demo``: a scene through a SOFA HRTF set, metered and written
  as a WAV file (``examples/binaural_demo.py``);
- ``pod_render``: the two-level render channel-sharded over a world of
  processes, metered with one all-reduce, and the communication model's
  projection (``examples/pod_render.py``).
"""

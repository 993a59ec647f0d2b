"""PyTorch/CUDA port of ``fedml_tpu`` for one NVIDIA H100.

The JAX package ``fedml_tpu`` is the reference; every module here is held
against its counterpart by the ``tests/test_torch_*.py`` parity tests. This
package imports ``torch`` and numpy, never JAX or anything of ``fedml_tpu``.
"""

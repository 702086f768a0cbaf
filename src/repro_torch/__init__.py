"""PyTorch + CUDA port of the BlockLLM serving stack (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage and module names (``configs``, ``models``, ``kernels``,
``adapters``, ``checkpoint``, ``obs``, ``runtime``, ``launch``) so each
counterpart is found under the same path.  It imports ``torch`` and
numpy only: never ``jax`` and never a module of ``repro``.

Kernels on the serving path are hand-written CUDA C++ for Hopper
(``kernels/csrc/*.cu``), built with ``nvcc`` at first use and bound with
``ctypes``.  Entry points run on the CUDA device unless the caller asks
for the CPU, where every kernel wrapper uses its plain PyTorch version.
"""

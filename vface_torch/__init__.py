"""PyTorch / CUDA port of vface_tpu for NVIDIA Hopper (H100).

The package mirrors ``vface_tpu``'s layout and names. It imports ``torch`` and
never ``jax``, ``flax`` or ``vface_tpu``; the JAX package is the reference the
port is tested against (``tests/test_torch_*.py``).

Public functions keep the JAX package's NHWC layout at their boundary; the
models run NCHW inside. Entry points run on ``device="cuda"`` unless the caller
asks for the CPU, and raise when CUDA is absent.

Hand-written kernels (``vface_torch/ops``):

* ``flash_attention`` — CUDA C++ (``csrc/flash_attention.cu``, its backward
  ``csrc/flash_attention_bwd.cu``; on fp32 operands ``csrc/flash_attention_f32.cu``
  and ``csrc/flash_attention_bwd_f32.cu``), replaces
  ``vface_tpu/ops/pallas_attention.py::flash_attention_v5``;
* ``geglu_ff`` — CUDA C++ (``csrc/geglu_ff.cu``, bf16 and fp32), replaces
  ``vface_tpu/ops/pallas_ff.py::geglu_ff``;
* ``gn_sums`` — CUDA C++ (``csrc/gn_sums.cu``), replaces
  ``vface_tpu/models/layers.py::_gn_sums_pallas``.

Every kernel is CUDA C++ with a plain C interface, built by ``nvcc`` at first
use and loaded with ``ctypes`` (``ops/_native.py``); ``PERF.md`` lists all
thirteen with their times on the card.
"""

__version__ = "0.1.0"

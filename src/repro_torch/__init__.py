"""repro_torch: the PyTorch/CUDA port of ``repro`` (LAQ + ML operator fusion).

The package mirrors ``src/repro/`` module for module — same relative paths,
same public names — with torch tensors where the reference holds jax arrays.
It never imports ``jax`` or ``repro``.

Devices: every entry point that creates data (``Table.from_columns``,
``data.ssb.generate``, ``data.synthetic.generate``) runs on ``cuda`` unless
the caller passes ``device="cpu"``; with no card and no ``device`` it raises
(:func:`repro_torch.device.resolve_device`).  ``compile_query`` follows its
tables' device.  The kernel wrappers dispatch on the device of the tensor
they are given: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.

TF32: this is the one place the port sets it, and it sets it off for both
matmuls and cuDNN.  Decision-tree thresholds compare exact fp32 products
(``x·F > v``); TF32's 10-bit mantissa would round those products and flip
leaves.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

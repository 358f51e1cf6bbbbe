"""Hand-written CUDA kernels of the port (one package per kernel).

Each kernel package ships ``csrc/*.cu`` (built with ``nvcc`` at first use,
see :mod:`repro_torch.kernels.build`), a ``kernel.py`` that binds the C
entry point with ``ctypes`` and checks its arguments, and an ``ops.py`` that
dispatches between the kernel (CUDA tensors) and the plain PyTorch version
(CPU tensors).

``LAUNCHES`` counts launches per kernel name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
really went through the kernels.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

"""DiffusionSAT on PyTorch and CUDA: the port of the TPU package to one
NVIDIA H100.

The package mirrors the TPU package's module layout and function names so
that each module's counterpart is easy to find. It imports torch and numpy
only. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where every hand-written kernel's wrapper runs the
kernel's plain PyTorch version instead.

Ported so far: the reverse-diffusion sampler (flat and dense chains), the
solving eval, and training (AdaBelief, the train steps of both layouts,
checkpoints and the ``diffusion_training`` script) of QuerySAT, with the
flat layout's literal-clause SpMM pair, forward and backward, on a CUDA
kernel (``csrc/segsum.cu``).
"""

__version__ = "0.1.0"

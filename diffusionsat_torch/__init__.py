"""DiffusionSAT on PyTorch and CUDA: the port of the TPU package to one
NVIDIA H100.

The package mirrors the TPU package's module layout and function names so
that each module's counterpart is easy to find. It imports torch and numpy
only. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where every hand-written kernel's wrapper runs the
kernel's plain PyTorch version instead.

Ported so far: the reverse-diffusion sampler (flat and dense chains), the
solving eval, training (AdaBelief, the train steps of both layouts,
checkpoints and the ``diffusion_training`` script), the uniformity battery
and the bank measurement, the ANF path (``anf_eval``, ``anf_training``),
many steps per dispatch as CUDA graphs (``cuda_graphs``, ``--mega_steps``),
the bench (``bench``), the generic driver ``main`` with its registry and
harness, every model of the registry (QuerySAT, ANFSAT, NeuroSAT,
NeuroCore, SimpleNeuroSAT, QuerySATLit, AttentionSAT), the TSP stack,
hyperopt and the ANF studies, and multi-device execution over
``torch.distributed`` (``parallel``: data parallelism, clause-partitioned
graph parallelism with the all-reduce or the halo exchange, the sharded
sampler chain). The flat layout's segment sums, forward and backward, run
on a CUDA kernel (``csrc/segsum.cu``).
"""

__version__ = "0.1.0"

from repro_torch.kernels.pdgraph_walk.ops import pdgraph_walk_ranked  # noqa: F401
from repro_torch.kernels.pdgraph_walk.ref import walker_streams  # noqa: F401

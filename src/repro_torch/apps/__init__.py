from repro_torch.apps.spec import AppSpec, UnitSpec, sample_trajectory  # noqa: F401
from repro_torch.apps.suite import SUITE, build_knowledge_base  # noqa: F401

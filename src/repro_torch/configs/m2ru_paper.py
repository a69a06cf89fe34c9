"""The paper's own network: 28×100×10 MiRU (Table I), plus the n_h=256
variant (Fig. 4b/4d). This is a MiRUConfig, not a ModelConfig — the
continual-learning stack (repro.core) consumes it directly."""
from repro_torch.core.miru import MiRUConfig

PAPER_CONFIG = MiRUConfig(n_x=28, n_h=100, n_y=10, beta=0.8, lam=0.5)
PAPER_CONFIG_256 = MiRUConfig(n_x=28, n_h=256, n_y=10, beta=0.8, lam=0.5)
CIFAR_FEATURE_CONFIG = MiRUConfig(n_x=32, n_h=100, n_y=2, beta=0.8, lam=0.5)

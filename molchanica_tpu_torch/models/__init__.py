"""ML models: ADME/toxicity GNN+MLP property predictors (torch)."""
from .adme import AdmeModel, AdmeModelConfig, featurize_mol  # noqa: F401

"""Architecture configs of the port: ``base`` (the fields its models
read, the layer plan, the registry) and the one registered language
model, RecurrentGemma-9B."""
from repro_torch.configs import recurrentgemma_9b  # noqa: F401  (registers)
from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401

"""Architecture configs of the port: ``base`` (the fields its models
read, the layer plan, the registry) and the registered language models,
RecurrentGemma-9B and xLSTM-125M."""
from repro_torch.configs import recurrentgemma_9b, xlstm_125m  # noqa: F401  (registers)
from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401

"""Architecture configs of the port: ``base`` (the fields its models
read, the layer plan, the registry) and the registered language models:
RecurrentGemma-9B, xLSTM-125M, the MoE family (DeepSeekMoE-16B,
Granite-3.0-1B-A400M) and the dense DeepSeek-7B and GLM-4-9B."""
from repro_torch.configs import (deepseek_7b, deepseek_moe_16b,  # noqa: F401
                                 glm4_9b, granite_moe_1b_a400m,
                                 recurrentgemma_9b, xlstm_125m)
from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401

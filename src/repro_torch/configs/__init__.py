"""Architecture configs of the port: ``base`` (the fields its models
read, the layer plans, the registry) and every config the reference
registers: RecurrentGemma-9B, xLSTM-125M, the MoE family
(DeepSeekMoE-16B, Granite-3.0-1B-A400M), the dense DeepSeek-7B,
GLM-4-9B, Command-R-35B and Qwen1.5-32B, the encoder-decoder
Whisper-medium and the vision-language InternVL2-26B."""
from repro_torch.configs import (command_r_35b, deepseek_7b,  # noqa: F401
                                 deepseek_moe_16b, glm4_9b,
                                 granite_moe_1b_a400m, internvl2_26b,
                                 qwen15_32b, recurrentgemma_9b,
                                 whisper_medium, xlstm_125m)
from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401

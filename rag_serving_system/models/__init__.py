from rag_serving_system.models.configs import (
    EncoderConfig,
    DecoderConfig,
    E5_LARGE,
    E5_TINY,
    QWEN25_15B,
    QWEN2_TINY,
    encoder_config_for,
    decoder_config_for,
)

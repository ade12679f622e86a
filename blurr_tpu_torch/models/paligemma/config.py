"""Plain-Python config classes of PaliGemma.

The port's own copy of ``blurr_tpu/models/paligemma/config.py`` (the
reference's ``src/model/paligemma/config.py``): the defaults are
``google/paligemma-3b-pt-224``'s widths. An HF ``config.json`` loads as
``PaliGemmaConfig(**json)``; keys the classes do not know are ignored.
"""

from __future__ import annotations


class SiglipVisionConfig:
    def __init__(
        self,
        hidden_size: int = 1152,
        intermediate_size: int = 4304,
        num_hidden_layers: int = 27,
        num_attention_heads: int = 16,
        num_channels: int = 3,
        image_size: int = 224,
        patch_size: int = 14,
        layer_norm_eps: float = 1e-6,
        attention_dropout: float = 0.0,
        num_image_tokens: int = None,
        **kwargs,
    ):
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_channels = num_channels
        self.image_size = image_size
        self.patch_size = patch_size
        self.layer_norm_eps = layer_norm_eps
        self.attention_dropout = attention_dropout
        self.num_image_tokens = num_image_tokens

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class GemmaConfig:
    def __init__(
        self,
        vocab_size: int = 257216,
        hidden_size: int = 2048,
        intermediate_size: int = 16384,
        num_hidden_layers: int = 18,
        num_attention_heads: int = 8,
        num_key_value_heads: int = 1,
        head_dim: int = 256,
        max_position_embeddings: int = 8192,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 10000.0,
        attention_bias: bool = False,
        attention_dropout: float = 0.0,
        pad_token_id: int = None,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.head_dim = head_dim
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.pad_token_id = pad_token_id

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class PaliGemmaConfig:
    def __init__(
        self,
        vision_config: dict = None,
        text_config: dict = None,
        ignore_index: int = -100,
        image_token_index: int = 256000,
        vocab_size: int = 257152,
        projection_dim: int = 2048,
        hidden_size: int = 2048,
        pad_token_id: int = None,
        **kwargs,
    ):
        self.ignore_index = ignore_index
        self.image_token_index = image_token_index
        self.vision_config = SiglipVisionConfig(**(vision_config or {}))
        # a transformers-serialized text_config carries pad_token_id too:
        # the top-level value wins (passing both would be a TypeError)
        text_config = dict(text_config or {})
        if pad_token_id is None:
            pad_token_id = text_config.get("pad_token_id")
        text_config.pop("pad_token_id", None)
        self.pad_token_id = pad_token_id
        self.text_config = GemmaConfig(**text_config, pad_token_id=pad_token_id)
        self.vocab_size = self.text_config.vocab_size
        self.projection_dim = projection_dim
        self.hidden_size = hidden_size
        # the image tokens follow from the image and patch sizes
        self.vision_config.num_image_tokens = (
            self.vision_config.image_size // self.vision_config.patch_size
        ) ** 2
        self.vision_config.projection_dim = projection_dim

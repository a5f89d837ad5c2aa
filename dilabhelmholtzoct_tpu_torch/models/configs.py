"""Model configurations for the PyTorch SAM family.

A copy of ``dilabhelmholtzoct_tpu/models/configs.py`` (the port imports
nothing of the JAX package). Shapes and defaults mirror HF ``SamConfig``, so
HF ``SamModel`` state_dicts load into the port by name.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class VisionConfig:
    """SAM ViTDet-style image encoder configuration."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)
    mlp_dim: int = 3072
    output_channels: int = 256
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    use_abs_pos: bool = True
    use_rel_pos: bool = True

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class PromptConfig:
    """SAM prompt encoder configuration."""

    hidden_size: int = 256
    image_embedding_size: int = 64
    input_image_size: int = 1024
    mask_input_channels: int = 16
    num_point_embeddings: int = 4
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class DecoderConfig:
    """SAM two-way-transformer mask decoder configuration."""

    hidden_size: int = 256
    num_layers: int = 2
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


@dataclass(frozen=True)
class SamConfig:
    """Full SAM configuration (vision + prompt + decoder)."""

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    prompt: PromptConfig = dataclasses.field(default_factory=PromptConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    num_pos_feats: int = 128  # half of the random-fourier positional channels


def sam_vit_base() -> SamConfig:
    """facebook/sam-vit-base (reference default, training.py:28)."""
    return SamConfig()


def sam_vit_large() -> SamConfig:
    return SamConfig(
        vision=VisionConfig(
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            mlp_dim=4096,
            global_attn_indexes=(5, 11, 17, 23),
        )
    )


def sam_vit_huge() -> SamConfig:
    return SamConfig(
        vision=VisionConfig(
            hidden_size=1280,
            num_layers=32,
            num_heads=16,
            mlp_dim=5120,
            global_attn_indexes=(7, 15, 23, 31),
        )
    )


def sam_tiny(image_size: int = 128) -> SamConfig:
    """A tiny config for fast unit tests (structure-identical to ViT-B)."""
    return SamConfig(
        vision=VisionConfig(
            hidden_size=64,
            num_layers=3,
            num_heads=4,
            image_size=image_size,
            patch_size=16,
            window_size=4,
            global_attn_indexes=(1,),
            mlp_dim=128,
            output_channels=32,
        ),
        prompt=PromptConfig(
            hidden_size=32,
            image_embedding_size=image_size // 16,
            input_image_size=image_size,
        ),
        decoder=DecoderConfig(
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            mlp_dim=64,
            iou_head_hidden_dim=32,
        ),
        num_pos_feats=16,
    )


_PRESETS = {
    "facebook/sam-vit-base": sam_vit_base,
    "facebook/sam-vit-large": sam_vit_large,
    "facebook/sam-vit-huge": sam_vit_huge,
    "wanglab/medsam-vit-base": sam_vit_base,  # MedSAM shares ViT-B geometry
    "sam-vit-base": sam_vit_base,
    "sam-vit-large": sam_vit_large,
    "sam-vit-huge": sam_vit_huge,
}


def register_preset(name: str, factory) -> None:
    """Register a custom ``--base_model`` name (tests, custom geometries)."""
    _PRESETS[name] = factory


def config_for(base_model: str) -> SamConfig:
    """Resolve a reference-style ``--base_model`` name to a config."""
    key = base_model.strip()
    if key in _PRESETS:
        return _PRESETS[key]()
    raise ValueError(
        f"Unknown base model {base_model!r}; known: {sorted(_PRESETS)}"
    )

from .sam import set_flash_attention, set_fused_i2t, set_fused_upscaler

__all__ = ["set_flash_attention", "set_fused_i2t", "set_fused_upscaler"]

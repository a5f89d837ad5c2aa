from .sam import set_fused_i2t, set_fused_upscaler

__all__ = ["set_fused_i2t", "set_fused_upscaler"]

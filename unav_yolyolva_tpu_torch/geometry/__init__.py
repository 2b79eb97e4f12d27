from .points import concat_points, generate_points, pyramid_strides

__all__ = ["concat_points", "generate_points", "pyramid_strides"]

"""Video-SfM pipeline layer: the registration, triangulation and
bundle-adjustment building blocks composed into the incremental session
workflow ``add_frame(matches) → register (PnP / RANSAC) → triangulate new
tracks → windowed BA``."""
from .session import SfmSession

__all__ = ["SfmSession"]

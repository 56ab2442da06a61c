from . import bal
from .bal import export_ply, load_bal, save_bal

__all__ = ["bal", "load_bal", "save_bal", "export_ply"]

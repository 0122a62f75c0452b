from .gbdt import Booster

__all__ = ["Booster"]

from .gradcheck import check_gradients

__all__ = ["check_gradients"]

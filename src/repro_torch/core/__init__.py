from repro_torch.core.unq import UNQ, UNQConfig

__all__ = ["UNQ", "UNQConfig"]

from .dataloader import DataLoader, RepeatingLoader, random_token_dataset
from .engine import Engine, initialize

__all__ = ["DataLoader", "Engine", "RepeatingLoader", "initialize",
           "random_token_dataset"]

from repro_torch.training.data import FEATURE_DIM, DifficultyDataset

__all__ = ["FEATURE_DIM", "DifficultyDataset"]

from .loader import DataLoader, collate
from .datasets.nuscenes import NuScenesDataset, build_pipeline

from gdrnet_tpu_torch.data.synthetic import synthetic_roi_batch
from gdrnet_tpu_torch.data.ref_meta import get_meta, DatasetMeta
from gdrnet_tpu_torch.data.bop import load_bop_scene_dicts
from gdrnet_tpu_torch.data.model_store import ObjectModels
from gdrnet_tpu_torch.data.mapper import GDRNTrainMapper, collate
from gdrnet_tpu_torch.data.loader import TrainLoader
from gdrnet_tpu_torch.data.augment import BackgroundReplacer, build_color_augmentor

__all__ = [
    "synthetic_roi_batch",
    "get_meta",
    "DatasetMeta",
    "load_bop_scene_dicts",
    "ObjectModels",
    "GDRNTrainMapper",
    "collate",
    "TrainLoader",
    "BackgroundReplacer",
    "build_color_augmentor",
]

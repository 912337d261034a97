"""The data layer: XShards, TPUDataset, FeatureSet, the readers and the
TFRecord codec.

The port of `analytics_zoo_tpu/data/__init__.py`, which exports the same
names and `RoiLabel`, `Coco`, `Imdb` and `PascalVoc` besides: `roi.py`
and `detection.py` go with the detection models (ROADMAP.md queue 1,
item 8)."""

from analytics_zoo_tpu_torch.data.shards import XShards, SparkXShards  # noqa: F401
from analytics_zoo_tpu_torch.data.dataset import TPUDataset  # noqa: F401
from analytics_zoo_tpu_torch.data.feature_set import FeatureSet  # noqa: F401
from analytics_zoo_tpu_torch.data import readers  # noqa: F401
from analytics_zoo_tpu_torch.data import tfrecord  # noqa: F401
from analytics_zoo_tpu_torch.data.readers import (  # noqa: F401
    read_csv, read_json, read_parquet)

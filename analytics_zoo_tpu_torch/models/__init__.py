from analytics_zoo_tpu_torch.models.common import ZooModel  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation import (  # noqa: F401
    NeuralCF, SessionRecommender, UserItemFeature, WideAndDeep)
from analytics_zoo_tpu_torch.models.anomalydetection import (  # noqa: F401
    AnomalyDetector, detect_anomalies, unroll)
from analytics_zoo_tpu_torch.models.textclassification import \
    TextClassifier  # noqa: F401
from analytics_zoo_tpu_torch.models.textmatching import KNRM  # noqa: F401
from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq  # noqa: F401
from analytics_zoo_tpu_torch.models.image import (  # noqa: F401
    ImageClassifier, resnet)

"""Anomaly detection over time series: an LSTM forecaster and threshold
detectors.

Port of `analytics_zoo_tpu/models/anomalydetection.py`: `AnomalyDetector`
(L21), stacked LSTMs (every one but the last returning sequences), each
followed by a `Dropout`, and a `Dense(1)` head trained on MSE (the
reference's `AnomalyDetector.scala:40`, py `anomaly_detector.py:61-76`);
and, copied as they are (numpy only), `unroll` (L58), `detect_anomalies`
(L74) and `ThresholdDetector` (L84).

`device` says where the parameters are created (None is `cuda`; the CPU
only when asked, as everywhere in the port).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.models.common import ZooModel


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2),
                 device: DeviceLike = None):
        super().__init__()
        if len(hidden_layers) != len(dropouts):
            raise ValueError("hidden_layers and dropouts lengths differ")
        self._config = dict(feature_shape=list(feature_shape),
                            hidden_layers=list(hidden_layers),
                            dropouts=list(dropouts))
        self.feature_shape = tuple(feature_shape)
        self.hidden_layers = list(hidden_layers)
        self.dropouts = list(dropouts)
        self.device = device
        self.model = self.build_model()

    def build_model(self) -> Sequential:
        dev = self.device
        m = Sequential()
        last = len(self.hidden_layers) - 1
        for i, (units, drop) in enumerate(zip(self.hidden_layers,
                                              self.dropouts)):
            m.add(L.LSTM(units, return_sequences=i < last, device=dev,
                         input_shape=self.feature_shape if i == 0 else None))
            m.add(L.Dropout(drop))
        m.add(L.Dense(1, device=dev))
        return m


def unroll(data: np.ndarray, unroll_length: int,
           predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: x[i] = data[i : i+L], y[i] = data[i+L+step-1, 0]
    (`anomaly_detector.py:105` unroll semantics)."""
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n = len(data) - unroll_length - predict_step + 1
    if n <= 0:
        raise ValueError("series too short for the requested unroll")
    x = np.stack([data[i:i + unroll_length] for i in range(n)])
    y = data[unroll_length + predict_step - 1:
             unroll_length + predict_step - 1 + n, 0]
    return x, y


def detect_anomalies(y_truth: np.ndarray, y_predict: np.ndarray,
                     anomaly_size: int) -> np.ndarray:
    """Indices of the `anomaly_size` largest absolute errors
    (`detect_anomalies`, `anomaly_detector.py:126`)."""
    err = np.abs(np.asarray(y_truth).reshape(-1)
                 - np.asarray(y_predict).reshape(-1))
    thresh = np.sort(err)[-anomaly_size]
    return np.where(err >= thresh)[0][:anomaly_size]


class ThresholdDetector:
    """`zouwu/model/anomaly.py` ThresholdDetector: fixed or percentile-based
    threshold on forecast error."""

    def __init__(self, threshold: Optional[float] = None,
                 ratio: float = 0.01):
        self.threshold = threshold
        self.ratio = ratio

    def fit(self, y_truth: np.ndarray, y_predict: np.ndarray):
        err = np.abs(np.asarray(y_truth) - np.asarray(y_predict)).reshape(-1)
        if self.threshold is None:
            self.threshold = float(np.quantile(err, 1.0 - self.ratio))
        return self

    def score(self, y_truth: np.ndarray, y_predict: np.ndarray) -> np.ndarray:
        if self.threshold is None:
            raise ValueError("fit() first or pass an explicit threshold")
        err = np.abs(np.asarray(y_truth) - np.asarray(y_predict)).reshape(-1)
        return (err > self.threshold).astype(np.int32)

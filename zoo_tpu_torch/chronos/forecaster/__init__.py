"""The Chronos forecasters (counterpart of
``zoo_tpu/chronos/forecaster``). Importing them needs neither pandas,
scikit-learn, prophet nor ray."""

from zoo_tpu_torch.chronos.forecaster.arima_forecaster import (  # noqa: F401
    ARIMAForecaster,
    ProphetForecaster,
)
from zoo_tpu_torch.chronos.forecaster.base import Forecaster  # noqa: F401
from zoo_tpu_torch.chronos.forecaster.lstm_forecaster import LSTMForecaster  # noqa: F401,E501
from zoo_tpu_torch.chronos.forecaster.mtnet_forecaster import MTNetForecaster  # noqa: F401,E501
from zoo_tpu_torch.chronos.forecaster.seq2seq_forecaster import Seq2SeqForecaster  # noqa: F401,E501
from zoo_tpu_torch.chronos.forecaster.tcmf_forecaster import TCMFForecaster  # noqa: F401,E501
from zoo_tpu_torch.chronos.forecaster.tcn_forecaster import TCNForecaster  # noqa: F401,E501

__all__ = ["Forecaster", "LSTMForecaster", "Seq2SeqForecaster",
           "TCNForecaster", "MTNetForecaster", "ARIMAForecaster",
           "ProphetForecaster", "TCMFForecaster"]

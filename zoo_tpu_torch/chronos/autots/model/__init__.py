from zoo_tpu_torch.chronos.autots.model.auto_arima import AutoARIMA  # noqa: F401
from zoo_tpu_torch.chronos.autots.model.auto_prophet import AutoProphet  # noqa: F401,E501

__all__ = ["AutoARIMA", "AutoProphet"]

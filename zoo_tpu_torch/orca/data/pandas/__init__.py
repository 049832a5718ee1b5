from zoo_tpu_torch.orca.data.pandas.preprocessing import (  # noqa: F401
    read_csv,
    read_json,
    read_parquet,
)

__all__ = ["read_csv", "read_json", "read_parquet"]

"""ray_tpu_torch.data — lazy streaming distributed datasets (Ray Data analog,
`python/ray/data/`)."""

from ray_tpu_torch.data.block import Block  # noqa: F401
from ray_tpu_torch.data.dataset import (  # noqa: F401
    ActorPoolStrategy,
    Dataset,
    GroupedData,
    MaterializedDataset,
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_bigquery,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_mongo,
    read_numpy,
    read_orc,
    read_parquet,
    read_sql,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("data")
del _rlu

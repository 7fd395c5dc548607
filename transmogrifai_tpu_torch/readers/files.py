"""File-format readers: CSV (with/without schema inference), Parquet, Avro,
JSON-lines (counterpart of ``transmogrifai_tpu/readers/files.py``, copied).
The CSV, Parquet and JSON-lines readers import pandas when built, the Avro
reader only the vendored codec.

Reference: readers/.../CSVReaders.scala, CSVAutoReaders.scala:1-142,
ParquetProductReader.scala:1-90, AvroReaders.scala:1-134, DataReaders.scala:44-278.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..data.dataset import Dataset
from ..features.feature import Feature
from .base import DataFrameReader, Reader


class CSVReader(DataFrameReader):
    """CSV -> columnar dataset.  ``headers=None`` auto-infers (CSVAutoReader)."""

    def __init__(self, path: str, headers: Optional[Sequence[str]] = None,
                 key_fn=None, **pandas_kwargs):
        import pandas as pd

        if headers is not None:
            df = pd.read_csv(path, header=None, names=list(headers), **pandas_kwargs)
        else:
            df = pd.read_csv(path, **pandas_kwargs)
        super().__init__(df, key_fn)
        self.path = path


class ParquetReader(DataFrameReader):
    def __init__(self, path: str, key_fn=None):
        import pandas as pd

        super().__init__(pd.read_parquet(path), key_fn)
        self.path = path


class JsonLinesReader(DataFrameReader):
    def __init__(self, path: str, key_fn=None):
        import pandas as pd

        super().__init__(pd.read_json(path, lines=True), key_fn)
        self.path = path


class AvroReader(Reader):
    """Avro object-container files via the vendored codec (readers/avro.py)
    — runnable with zero dependencies, null + deflate codecs.

    Reference: AvroReaders.scala:1-134 (AvroReaders.Simple).
    """

    def __init__(self, path: str, key_fn=None):
        super().__init__(key_fn)
        self.path = path

    @property
    def schema(self):
        from .avro import read_schema

        return read_schema(self.path)  # header-only read, no data blocks

    def read_records(self):
        from .avro import read_container

        _, records = read_container(self.path)
        yield from records


class StreamingReader:
    """Micro-batch scoring source (reference StreamingReaders, DStream equivalent).

    Wraps an iterator of record batches; each batch becomes a Dataset for scoring.
    """

    def __init__(self, batches):
        self.batches = batches

    def stream_datasets(self, raw_features: Sequence[Feature]):
        from .base import rows_to_dataset

        for batch in self.batches:
            if isinstance(batch, Dataset):
                yield batch
            elif isinstance(batch, Reader):
                yield batch.generate_dataset(
                    _scoring_features(raw_features, batch))
            elif hasattr(batch, "columns") and hasattr(batch, "iloc"):
                # pandas DataFrame: columnar fast path, not iteration over col names
                yield DataFrameReader(batch).generate_dataset(
                    _scoring_features(raw_features, batch))
            else:
                yield rows_to_dataset(list(batch), raw_features,
                                      allow_missing_response=True)


def _scoring_features(raw_features: Sequence[Feature], batch):
    """The scoring-time contract for columnar batches: response features whose
    source column is ABSENT from the batch are dropped (labels are optional at
    scoring time — same tolerance the record-iterator path gets from
    ``allow_missing_response``); predictors always stay, so a missing
    predictor column still fails loudly downstream."""
    from ..features.feature import _NamedExtract

    cols = set(batch.columns) if hasattr(batch, "columns") else None
    out = []
    for f in raw_features:
        st = f.origin_stage
        if getattr(st, "is_response", False) and cols is not None \
                and isinstance(getattr(st, "extract_fn", None), _NamedExtract) \
                and st.extract_fn.key not in cols:
            continue
        out.append(f)
    return out


class DataReaders:
    """Factory mirroring reference ``DataReaders.Simple/Aggregate/Conditional``."""

    class Simple:
        @staticmethod
        def csv(path: str, headers: Optional[Sequence[str]] = None, key_fn=None,
                **kw) -> CSVReader:
            return CSVReader(path, headers=headers, key_fn=key_fn, **kw)

        @staticmethod
        def csv_auto(path: str, key_fn=None, **kw) -> CSVReader:
            return CSVReader(path, headers=None, key_fn=key_fn, **kw)

        @staticmethod
        def parquet(path: str, key_fn=None) -> ParquetReader:
            return ParquetReader(path, key_fn=key_fn)

        @staticmethod
        def avro(path: str, key_fn=None) -> AvroReader:
            return AvroReader(path, key_fn=key_fn)

        @staticmethod
        def json_lines(path: str, key_fn=None) -> JsonLinesReader:
            return JsonLinesReader(path, key_fn=key_fn)

        @staticmethod
        def dataframe(df, key_fn=None) -> DataFrameReader:
            return DataFrameReader(df, key_fn=key_fn)

    class Aggregate:
        @staticmethod
        def csv(path: str, key_fn, time_fn, cutoff, headers=None, **kw):
            from .base import AggregateReader

            return AggregateReader(CSVReader(path, headers=headers, **kw),
                                   key_fn=key_fn, time_fn=time_fn, cutoff=cutoff)

        @staticmethod
        def dataframe(df, key_fn, time_fn, cutoff):
            from .base import AggregateReader, DataFrameReader

            return AggregateReader(DataFrameReader(df), key_fn=key_fn,
                                   time_fn=time_fn, cutoff=cutoff)

    class Conditional:
        @staticmethod
        def dataframe(df, key_fn, time_fn, condition_fn, drop_if_no_condition=True):
            from .base import ConditionalReader, DataFrameReader

            return ConditionalReader(DataFrameReader(df), key_fn=key_fn, time_fn=time_fn,
                                     condition_fn=condition_fn,
                                     drop_if_no_condition=drop_if_no_condition)

"""Stage framework: params, transformers and the device protocol on torch tensors.

Counterpart of ``transmogrifai_tpu/stages/base.py``.  Stages operate on whole
columns.  A transformer whose column kernel can run on the device also
exposes the device protocol the serving plan (``serve/plan.py``) drives:

- ``device_input_slots``: the input slots ``device_transform`` reads (``None``
  = all), so a label slot absent at serve time is never wired;
- ``device_lifts_input(slot)`` / ``encode_device_input(slot, col)``: a
  host-kind input (text levels) the stage encodes itself into an int32
  operand, one value per row;
- ``device_transform(*tensors) -> tensor``: the device half of
  ``transform_columns``, on torch tensors that all lie on one device.

The contract is the reference's: row-local (row ``i`` of the output depends
only on row ``i`` of the inputs, so padded rows never reach real ones) and a
trailing output shape fixed by the fitted state alone.  Numeric operands
arrive as float32 with NaN for missing.

Stages are rebuilt from saved models through ``STAGE_REGISTRY``, keyed by the
reference class names; the port registers only what it implements.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from ..features.feature import Feature

if TYPE_CHECKING:  # pragma: no cover
    from ..data.dataset import Column, Dataset


class Param:
    """Stage parameter with a default; values resolve instance > default."""

    __slots__ = ("name", "default")

    def __init__(self, default: Any = None):
        self.name: str = ""
        self.default = default

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._param_values.get(self.name, self.default)

    def __set__(self, obj, value):
        obj._param_values[self.name] = value


#: reference class name -> port class, filled by ``__init_subclass__``
STAGE_REGISTRY: Dict[str, type] = {}


class PipelineStage:
    """Base of all stages."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        STAGE_REGISTRY[cls.__name__] = cls

    def __init__(self, operation_name: Optional[str] = None, uid: str = "",
                 **params):
        self._param_values: Dict[str, Any] = {}
        self.operation_name = operation_name or (
            type(self).__name__[0].lower() + type(self).__name__[1:])
        self.uid = uid or f"{type(self).__name__}_{id(self):012x}"
        self._input_features: Tuple[Feature, ...] = ()
        self._output_feature: Optional[Feature] = None
        cls_params = self._class_params()
        for k, v in params.items():
            if k not in cls_params:
                raise TypeError(f"{type(self).__name__} has no param {k!r}")
            setattr(self, k, v)

    @classmethod
    def _class_params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    @property
    def inputs(self) -> Tuple[Feature, ...]:
        return self._input_features

    def get_output(self) -> Feature:
        if self._output_feature is None:
            raise ValueError(f"{type(self).__name__} {self.uid} has no output feature")
        return self._output_feature

    @property
    def output_name(self) -> str:
        return self.get_output().name

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid})"


class Transformer(PipelineStage):
    """A stage with no fit step: a pure column function, optionally with a
    device half (see the module docstring)."""

    device_input_slots: Optional[Tuple[int, ...]] = None

    def device_lifts_input(self, slot: int) -> bool:
        return False

    def encode_device_input(self, slot: int, col: "Column"):
        raise NotImplementedError(
            f"{type(self).__name__} declares no device encoding for slot {slot}")

    def transform_columns(self, cols: List["Column"], dataset: "Dataset") -> "Column":
        raise NotImplementedError

    def transform(self, dataset: "Dataset") -> "Dataset":
        cols = [dataset[f.name] for f in self.inputs]
        out = self.transform_columns(cols, dataset)
        return dataset.with_column(self.output_name, out)


class Estimator(PipelineStage):
    """A stage that must observe data before it can transform.  The port does
    not fit; a saved model's estimator nodes load as :class:`EstimatorStub`
    and score through the fitted model saved under the same uid."""


class EstimatorStub(Estimator):
    """DAG placeholder for a saved estimator node: uid and wiring only."""

    def __init__(self, estimator_class: str, uid: str,
                 operation_name: Optional[str] = None):
        super().__init__(operation_name=operation_name, uid=uid)
        self.estimator_class = estimator_class

    def __repr__(self) -> str:
        return f"EstimatorStub({self.estimator_class}, uid={self.uid})"

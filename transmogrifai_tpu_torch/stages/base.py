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
  ``transform_columns``, on torch tensors that all lie on one device;
- ``device_slot_specs()``: for a stage whose device half is the encode
  kernel (``perf/kernels/encode.py``), one slot per device input, so the
  serving plan can encode it together with every other such stage in one
  launch (``None``: the stage runs its own ``device_transform``).

The contract is the reference's: row-local (row ``i`` of the output depends
only on row ``i`` of the inputs, so padded rows never reach real ones) and a
trailing output shape fixed by the fitted state alone.  Numeric operands
arrive as float32 with NaN for missing.

Stages are rebuilt from saved models through ``STAGE_REGISTRY``, keyed by the
reference class names; the port registers only what it implements.

Stages are also wired by hand: ``feature.transform_with(stage, *others)``
sets the stage's inputs (checked against ``input_types``, and for the
sequence stages against ``sequence_input_type``) and creates its output
feature.  An estimator's ``fit(dataset, device=None)`` fits on the
CUDA card unless ``device`` names another device, and returns its model
bound to the estimator's uid, inputs and output feature.
"""

from __future__ import annotations

import copy as _copy
import itertools
import weakref
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
)

from ..features.feature import Feature, feature_uid
from ..types import FeatureType, OPVector

if TYPE_CHECKING:  # pragma: no cover
    from ..data.dataset import Column, Dataset


class Param:
    """Stage parameter with a default and an optional validator; values
    resolve instance > default."""

    __slots__ = ("name", "default", "doc", "validator")

    def __init__(self, default: Any = None, doc: str = "",
                 validator: Optional[Callable[[Any], bool]] = None):
        self.name: str = ""
        self.default = default
        self.doc = doc
        self.validator = validator

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._param_values.get(self.name, self.default)

    def __set__(self, obj, value):
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"Invalid value for param {self.name!r}: {value!r}")
        obj._param_values[self.name] = value


#: reference class name -> port class, filled by ``__init_subclass__``
STAGE_REGISTRY: Dict[str, type] = {}
#: every live stage by uid (weakly held): the constructor's TM102 check
_LIVE_STAGES: "weakref.WeakValueDictionary[str, PipelineStage]" = \
    weakref.WeakValueDictionary()

_uid_counter = itertools.count()


def stage_uid(cls_name: str) -> str:
    return f"{cls_name}_{next(_uid_counter):012x}"


class PipelineStage:
    """Base of all stages."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        STAGE_REGISTRY[cls.__name__] = cls  # opcheck: allow(TM306) class registration, at class definition (import time)

    #: expected input feature types, one per input (fixed-arity stages)
    input_types: Tuple[Type[FeatureType], ...] = ()
    #: for sequence stages: the one repeated input type (variable arity)
    sequence_input_type: Optional[Type[FeatureType]] = None
    #: the fewest sequence inputs
    min_sequence_inputs: int = 1
    output_type: Type[FeatureType] = OPVector
    #: whether a response feature may feed this stage as a non-label input
    allow_label_as_input: bool = False
    #: whether the constructor holds the uid to the TM102 check (a loaded
    #: model's estimator node is not a live stage of its own, as a stage the
    #: reference's loader rebuilds is not)
    _live_uid: bool = True
    #: whether the output is flagged as a response feature (a stage that
    #: indexes a response makes the label, StringIndexer's case)
    output_is_response: bool = False

    def __init__(self, operation_name: Optional[str] = None, uid: str = "",
                 **params):
        self._param_values: Dict[str, Any] = {}
        self.operation_name = operation_name or (
            type(self).__name__[0].lower() + type(self).__name__[1:])
        if uid and self._live_uid:
            # counter-generated uids are unique by construction; only an
            # explicit uid can collide.  A same-class collision is legal
            # (re-loading a saved model builds equivalent stages) and is
            # caught at the DAG level if both land in one workflow; a
            # different-class collision can only be corruption — scoring
            # substitutes fitted models BY UID, so it would silently run the
            # wrong model
            other = _LIVE_STAGES.get(uid)
            if other is not None and type(other) is not type(self):
                raise ValueError(
                    f"[TM102] duplicate stage uid {uid!r}: already held by a "
                    f"live {type(other).__name__}; uid-keyed scoring "
                    "substitution would silently shadow one of the stages")
        self.uid = uid or stage_uid(type(self).__name__)
        if self._live_uid:
            _LIVE_STAGES[self.uid] = self
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

    def get_params(self) -> Dict[str, Any]:
        """Every param's value, defaults resolved (what a saved model records)."""
        return {name: getattr(self, name) for name in self._class_params()}

    def set_params(self, **kwargs) -> "PipelineStage":
        cls_params = self._class_params()
        for k, v in kwargs.items():
            if k not in cls_params:
                raise TypeError(f"{type(self).__name__} has no param {k!r}")
            setattr(self, k, v)
        return self

    def copy(self) -> "PipelineStage":
        """Same params, uid and wiring; an independent param dict (the
        per-grid copies of a sweep)."""
        clone = _copy.copy(self)
        clone._param_values = dict(self._param_values)
        return clone

    # --- input wiring -------------------------------------------------------
    def set_input(self, *features: Feature) -> "PipelineStage":
        self._check_input_schema(features)
        self._input_features = tuple(features)
        self._output_feature = None
        return self

    def _check_input_schema(self, features: Sequence[Feature]) -> None:
        if self.sequence_input_type is not None:
            fixed = len(self.input_types)
            if len(features) < fixed + self.min_sequence_inputs:
                raise ValueError(
                    f"{type(self).__name__} expects at least "
                    f"{fixed + self.min_sequence_inputs} inputs, got {len(features)}")
            expected = list(self.input_types) + [self.sequence_input_type] * (
                len(features) - fixed)
        else:
            if len(features) != len(self.input_types):
                raise ValueError(f"{type(self).__name__} expects "
                                 f"{len(self.input_types)} inputs, got {len(features)}")
            expected = list(self.input_types)
        for want, f in zip(expected, features):
            if not issubclass(f.ftype, want):
                raise TypeError(f"Feature {f.name!r} has type {f.ftype.__name__}, "
                                f"expected {want.__name__}")
        if not self.allow_label_as_input:
            for f in features:
                if f.is_response and not self._is_label_slot(f, features):
                    raise ValueError(
                        f"{type(self).__name__} received response feature "
                        f"{f.name!r} as input; response features may only "
                        "feed label-aware stages")

    def _is_label_slot(self, feature: Feature, features: Sequence[Feature]) -> bool:
        return False

    @property
    def inputs(self) -> Tuple[Feature, ...]:
        return self._input_features

    @property
    def input_names(self) -> List[str]:
        return [f.name for f in self._input_features]

    def _output_ftype(self) -> Type[FeatureType]:
        """The output feature's type (a stage whose type follows its input
        overrides this)."""
        return self.output_type

    def make_output_name(self) -> str:
        base = "-".join(f.name for f in self._input_features) or "raw"
        return f"{base}_{self.operation_name}_{self.uid.rsplit('_', 1)[-1]}"

    def get_output(self) -> Feature:
        if self._output_feature is None:
            if not self._input_features:
                raise ValueError(f"{type(self).__name__} {self.uid} has no "
                                 "output feature (set_input first)")
            self._output_feature = Feature(
                name=self.make_output_name(), ftype=self._output_ftype(),
                is_response=bool(self.output_is_response), origin_stage=self,
                parents=self._input_features, uid=feature_uid())
        return self._output_feature

    @property
    def output_name(self) -> str:
        return self.get_output().name

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid})"


class Transformer(PipelineStage):
    """A stage with no fit step: a pure column function, optionally with a
    device half (see the module docstring)."""

    #: True on a model an :class:`Estimator` fitted (set by ``_bind_model``)
    is_model: bool = False

    device_input_slots: Optional[Tuple[int, ...]] = None

    def device_lifts_input(self, slot: int) -> bool:
        return False

    def encode_device_input(self, slot: int, col: "Column"):
        raise NotImplementedError(
            f"{type(self).__name__} declares no device encoding for slot {slot}")

    def device_input_spec(self, slot: int):
        """(trailing shape, dtype name) of the operand
        :meth:`encode_device_input` makes for ``slot``: one int32 code a row
        by default."""
        return (), "int32"

    def device_slot_specs(self) -> Optional[tuple]:
        return None

    def transform_columns(self, cols: List["Column"], dataset: "Dataset") -> "Column":
        raise NotImplementedError

    def transform(self, dataset: "Dataset") -> "Dataset":
        cols = [dataset[f.name] for f in self.inputs]
        out = self.transform_columns(cols, dataset)
        return dataset.with_column(self.output_name, out)

    def transform_values(self, values: Sequence[Any]) -> Any:
        """One row: the inputs' raw values -> the output value, through a
        one-row dataset (a stage with a cheap scalar path overrides this)."""
        from ..data.dataset import Dataset

        ds = Dataset.from_features(
            {f.name: [v] for f, v in zip(self.inputs, values)},
            {f.name: f.ftype for f in self.inputs})
        col = self.transform_columns([ds[f.name] for f in self.inputs], ds)
        return col.to_values(self._output_ftype())[0]


class Estimator(PipelineStage):
    """A stage that must observe data before it can transform.  A saved
    model's estimator nodes load as :class:`EstimatorStub` and score through
    the fitted model saved under the same uid."""

    def fit_columns(self, cols: List["Column"], dataset: "Dataset", device):
        raise NotImplementedError

    def fit(self, dataset: "Dataset", device=None) -> Transformer:
        """Fit on ``device`` (the CUDA card unless the caller names another;
        with no card and no device this raises)."""
        from ..perf.kernels.dispatch import resolve_device

        dev = resolve_device(device)
        cols = [dataset[f.name] for f in self.inputs]
        return self._bind_model(self.fit_columns(cols, dataset, dev))

    def _bind_model(self, model: Transformer) -> Transformer:
        """The model shares uid, inputs and output feature with its estimator."""
        model.uid = self.uid
        model.operation_name = self.operation_name
        model._input_features = self._input_features
        model._output_feature = self.get_output()
        model.is_model = True
        return model


class UnaryTransformer(Transformer):
    """1 input -> 1 output."""


class BinaryTransformer(Transformer):
    """2 inputs -> 1 output."""


class TernaryTransformer(Transformer):
    """3 inputs -> 1 output."""


class QuaternaryTransformer(Transformer):
    """4 inputs -> 1 output."""


class SequenceTransformer(Transformer):
    """N inputs of ``sequence_input_type`` -> 1 output."""


class UnaryEstimator(Estimator):
    """1 input -> a fitted model."""


class BinaryEstimator(Estimator):
    """2 inputs (a label and a feature) -> a fitted model."""


class TernaryEstimator(Estimator):
    """3 inputs -> a fitted model."""


class SequenceEstimator(Estimator):
    """N inputs of ``sequence_input_type`` -> a fitted model."""


class BinarySequenceEstimator(Estimator):
    """1 fixed input + N inputs of ``sequence_input_type`` (a label and
    features) -> a fitted model."""


class UnaryLambdaTransformer(UnaryTransformer):
    """Host elementwise transformer from a per-value function (the
    reference's ``transformFn: I => O``), for host-kind columns: each
    value of the input goes through ``fn`` and the results make a column of
    ``output_type``."""

    def __init__(self, fn: Callable[[Any], Any], input_type: Type[FeatureType],
                 output_type: Type[FeatureType], operation_name: Optional[str] = None,
                 fn_name: Optional[str] = None, **kw):
        self.input_types = (input_type,)
        self.output_type = output_type
        super().__init__(operation_name=operation_name or fn_name or "lambda", **kw)
        self.fn = fn
        self.fn_name = fn_name

    def transform_columns(self, cols, dataset):
        from ..data.dataset import Column

        values = [self.fn(v) for v in cols[0].to_values()]
        return Column.from_values(self.output_type, [
            v.value if isinstance(v, FeatureType) else v for v in values])


class EstimatorStub(Estimator):
    """DAG placeholder for a saved estimator node: uid and wiring only.  Its
    declared wiring (input and output types, the label slot) is its
    estimator class's where the port has that class, so the static
    validator (``checkers/opcheck.py``) checks a loaded DAG as the
    reference, which loads the estimator class itself, does."""

    _DECLARED = ("input_types", "sequence_input_type", "min_sequence_inputs",
                 "output_type", "allow_label_as_input")
    _live_uid = False

    def __init__(self, estimator_class: str, uid: str,
                 operation_name: Optional[str] = None):
        super().__init__(operation_name=operation_name, uid=uid)
        self.estimator_class = estimator_class
        cls = self._estimator_cls()
        if cls is not None:
            for k in self._DECLARED:
                setattr(self, k, getattr(cls, k))

    def _estimator_cls(self):
        cls = STAGE_REGISTRY.get(self.estimator_class)
        return None if cls is None or cls is EstimatorStub else cls

    def _is_label_slot(self, feature: Feature, features: Sequence[Feature]) -> bool:
        cls = self._estimator_cls()
        if cls is not None:
            try:
                return cls._is_label_slot(self, feature, features)
            except AttributeError:  # the class's rule reads fitted state
                pass
        return super()._is_label_slot(feature, features)

    def _output_ftype(self):
        cls = self._estimator_cls()
        return cls._output_ftype(self) if cls is not None else super()._output_ftype()

    def __repr__(self) -> str:
        return f"EstimatorStub({self.estimator_class}, uid={self.uid})"

"""Save and load models in the reference's format (counterpart of
``transmogrifai_tpu/workflow/serde.py``).

A saved model is a directory with ``model.json.gz`` (the manifest: features,
stage states, fitted-model states) and ``arrays.npz`` (every numpy array the
states hold), at ``FORMAT_VERSION`` 1.  Both packages write it and both read
it: the loader carries the JAX package's fitted parameters, as numpy arrays,
into the port's stages, and :func:`save_model` writes the port's fitted
stages under the reference's class names, attributes and summary
dataclasses, so the reference's ``WorkflowModel.load`` reads them back.

Loading:

- transformer and fitted-model states rebuild through the port's
  ``STAGE_REGISTRY``, keyed by the reference class names, with their params
  and attributes restored as saved (arrays stay numpy);
- the selector's and the sanity checker's summaries restore as the port's
  dataclasses (``ModelSelectorSummary``, ``SanityCheckerSummary``, ...);
- estimator nodes were saved as stubs (uid + wiring) and load as
  :class:`~..stages.base.EstimatorStub`; scoring resolves them to the fitted
  model saved under the same uid;
- a stage class the port does not have raises ``ValueError`` naming it, and
  nothing is returned: a model never loads half-built.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..stages.base import (
    Estimator,
    EstimatorStub,
    PipelineStage,
    STAGE_REGISTRY,
    Transformer,
)
from ..types import feature_type_by_name
from ..utils.vector_metadata import VectorMetadata

FORMAT_VERSION = 1


def _register_stages() -> None:
    """Import every module that defines a ported stage class."""
    from ..checkers import sanity  # noqa: F401
    from ..models import (  # noqa: F401
        glm,
        linear,
        logistic,
        naive_bayes,
        selector,
        softmax,
        svm,
        trees,
    )
    from ..ops import (  # noqa: F401
        bucketizers,
        combiner,
        dates,
        geo,
        numeric,
        onehot,
        scalers,
        text_lists,
        text_smart,
    )


class _Decoder:
    def __init__(self, arrays):
        self.arrays = arrays

    def decode(self, v: Any) -> Any:
        if not isinstance(v, dict):
            return v
        if "__ndarray__" in v:
            return self.arrays[v["__ndarray__"]]
        if "__list__" in v:
            items = [self.decode(x) for x in v["__list__"]]
            return tuple(items) if v.get("__tuple__") else items
        if "__set__" in v:
            return {self.decode(x) for x in v["__set__"]}
        if "__dict__" in v:
            return {self.decode(k): self.decode(x) for k, x in v["__dict__"]}
        if "__named_extract__" in v:
            return _NamedExtract(v["__named_extract__"])
        if "__stage__" in v:
            return decode_stage(v["__stage__"], self)
        if "__vector_metadata__" in v:
            return VectorMetadata.from_dict(v["__vector_metadata__"])
        if "__dataclass__" in v:
            return _restore_dataclass(v["__dataclass__"], self.decode(v["data"]))
        if "__registered_fn__" in v or "__imported_fn__" in v:
            raise ValueError(
                f"saved function {v.get('__registered_fn__') or v.get('__imported_fn__')!r} "
                "is not ported to transmogrifai_tpu_torch: only named-field "
                "extracts load")
        if "__unserializable__" in v:
            return None
        return {k: self.decode(x) for k, x in v.items()}


def _restore_dataclass(name: str, data):
    """The selector's and the sanity checker's summaries and their parts
    restore as the port's dataclasses (the reference's names and fields);
    any other summary as plain data."""
    from ..checkers.sanity import ColumnStats, SanityCheckerSummary
    from ..models.selector import ModelSelectorSummary
    from ..models.tuning import ModelEvaluation, PrepSummary

    cls = {"ModelSelectorSummary": ModelSelectorSummary,
           "ModelEvaluation": ModelEvaluation, "PrepSummary": PrepSummary,
           "SanityCheckerSummary": SanityCheckerSummary,
           "ColumnStats": ColumnStats}.get(name)
    if cls is None or not isinstance(data, dict):
        return data
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    return cls(**{k: v for k, v in data.items() if k in names})


def decode_stage(state: dict, dec: _Decoder) -> PipelineStage:
    cls_name = state["class"]
    if "generator" in state:
        g = state["generator"]
        extract = dec.decode(g["extract"]) or _NamedExtract(g["rawName"])
        return FeatureGeneratorStage(
            extract_fn=extract, ftype=feature_type_by_name(g["ftype"]),
            output_name=g["rawName"], is_response=g["isResponse"],
            uid=state["uid"])
    if not state.get("full", True):
        return EstimatorStub(cls_name, uid=state["uid"],
                             operation_name=state["operationName"])
    cls = STAGE_REGISTRY.get(cls_name)
    if cls is None or cls is EstimatorStub:
        raise ValueError(
            f"stage class {cls_name!r} (uid {state['uid']}) is not ported to "
            "transmogrifai_tpu_torch yet; this model cannot load")
    stage = object.__new__(cls)
    stage._param_values = {}
    stage.uid = state["uid"]
    stage.operation_name = state["operationName"]
    stage._input_features = ()
    stage._output_feature = None
    params = dec.decode(state["params"]) or {}
    cls_params = stage._class_params()
    for k, v in params.items():
        if k in cls_params:
            stage._param_values[k] = v
    for k, v in (state.get("attrs") or {}).items():
        setattr(stage, k, dec.decode(v))
    return stage


def load_model(path: str):
    """Rebuild the ``WorkflowModel`` saved at ``path`` by the reference."""
    from .workflow import WorkflowModel

    _register_stages()
    with gzip.open(os.path.join(path, "model.json.gz"), "rt") as fh:
        manifest = json.load(fh)
    if manifest["formatVersion"] > FORMAT_VERSION:
        raise ValueError(
            f"model saved by format version {manifest['formatVersion']}; this "
            f"loader reads up to {FORMAT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as npz:
        dec = _Decoder({k: npz[k] for k in npz.files})

    uids = [s["uid"] for s in manifest["stages"]]
    dups = sorted({u for u in uids if uids.count(u) > 1})
    if dups:
        raise ValueError(f"[TM102] model manifest contains duplicate stage uid(s): {dups}")
    stage_states = {s["uid"]: s for s in manifest["stages"]}
    feat_states = {f["uid"]: f for f in manifest["features"]}
    stages: Dict[str, PipelineStage] = {}
    features: Dict[str, Feature] = {}

    def build_stage(uid: str, parents: Tuple[Feature, ...]) -> PipelineStage:
        if uid not in stages:
            st = decode_stage(stage_states[uid], dec)
            st._input_features = parents
            stages[uid] = st
        return stages[uid]

    def build_feature(uid: str) -> Feature:
        if uid in features:
            return features[uid]
        fs = feat_states[uid]
        parents = tuple(build_feature(p) for p in fs["parentUids"])
        origin = None
        if fs["originStageUid"] is not None:
            origin = build_stage(fs["originStageUid"], parents)
        feat = Feature(name=fs["name"], ftype=feature_type_by_name(fs["ftype"]),
                       is_response=fs["isResponse"], origin_stage=origin,
                       parents=parents, uid=uid)
        features[uid] = feat
        if origin is not None:
            origin._output_feature = feat
        return feat

    result_features = [build_feature(u) for u in manifest["resultFeatureUids"]]

    fitted: Dict[str, Transformer] = {}
    for uid, s in manifest["fitted"].items():
        t = decode_stage(s, dec)
        if uid in stages:
            t._input_features = stages[uid]._input_features
            t._output_feature = stages[uid]._output_feature
        else:
            t._input_features = tuple(
                features[u] for u in s["inputUids"] if u in features)
        fitted[uid] = t

    return WorkflowModel(result_features=result_features, fitted=fitted)


# -- save -------------------------------------------------------------------------

#: attributes every stage has that the manifest records elsewhere, and
#: runtime-only caches
_SKIP_ATTRS = {"_param_values", "_input_features", "_output_feature",
               "operation_name", "uid", "_code_memos", "_device_consts"}


class _Encoder:
    """JSON-able encoding of stage state, the reference's tags; arrays go to
    ``arrays`` under ``a0``, ``a1``, ..."""

    def __init__(self):
        self.arrays: Dict[str, np.ndarray] = {}

    def _store(self, arr: np.ndarray) -> dict:
        key = f"a{len(self.arrays)}"
        self.arrays[key] = arr
        return {"__ndarray__": key}

    def encode(self, v: Any) -> Any:
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return self._store(v)
        if isinstance(v, (list, tuple)):
            return {"__list__": [self.encode(x) for x in v],
                    "__tuple__": isinstance(v, tuple)}
        if isinstance(v, set):
            return {"__set__": [self.encode(x) for x in sorted(v)]}
        if isinstance(v, dict):
            return {"__dict__": [[self.encode(k), self.encode(x)] for k, x in v.items()]}
        if isinstance(v, _NamedExtract):
            return {"__named_extract__": v.key}
        if isinstance(v, PipelineStage):
            return {"__stage__": encode_stage(v, self, full=True)}
        if isinstance(v, VectorMetadata):
            return {"__vector_metadata__": v.to_dict()}
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {"__dataclass__": type(v).__name__,
                    "data": self.encode({f.name: getattr(v, f.name)
                                         for f in dataclasses.fields(v)})}
        raise ValueError(f"cannot save a value of type {type(v).__name__}: {v!r}")


def encode_stage(stage: PipelineStage, enc: _Encoder, full: bool) -> dict:
    """A stage's state under its reference class name: params and wiring,
    and with ``full`` every attribute."""
    out = {"class": getattr(stage, "estimator_class", type(stage).__name__),
           "uid": stage.uid, "operationName": stage.operation_name,
           "params": enc.encode(stage.get_params()),
           "inputUids": [f.uid for f in stage.inputs], "full": full}
    if isinstance(stage, FeatureGeneratorStage):
        out["generator"] = {"rawName": stage.raw_name,
                            "ftype": stage.ftype.__name__,
                            "isResponse": stage.is_response,
                            "extract": enc.encode(stage.extract_fn),
                            "windowMs": None}
        return out
    if full:
        out["attrs"] = {k: enc.encode(v) for k, v in vars(stage).items()
                        if k not in _SKIP_ATTRS and not k.startswith("__")}
    return out


def _all_features(result_features) -> List[Feature]:
    """Every feature the result features descend from, themselves included,
    each once."""
    seen: Dict[str, Feature] = {}
    stack = list(result_features)
    while stack:
        f = stack.pop()
        if f.uid not in seen:
            seen[f.uid] = f
            stack.extend(f.parents)
    return list(seen.values())


def save_model(model, path: str) -> None:
    """Write ``model`` (a fitted or loaded ``WorkflowModel``) to the
    directory ``path`` in FORMAT_VERSION 1.  Estimator nodes are saved as
    stubs (uid + wiring): scoring resolves them to the fitted model saved
    under the same uid."""
    import torch

    from .. import __version__

    os.makedirs(path, exist_ok=True)
    enc = _Encoder()
    features = _all_features(model.result_features)
    stages: Dict[str, PipelineStage] = {}
    for f in features:
        st = f.origin_stage
        if st is None:
            continue
        if stages.setdefault(st.uid, st) is not st:
            raise ValueError(f"[TM102] duplicate stage uid {st.uid!r} in DAG; "
                             "refusing to save a model that cannot round-trip")
    manifest = {
        "formatVersion": FORMAT_VERSION,
        "versionInfo": {"version": __version__, "torch": torch.__version__},
        "resultFeatureUids": [f.uid for f in model.result_features],
        "blacklist": [],
        "workflowCv": False,
        "features": [{"uid": f.uid, "name": f.name, "ftype": f.ftype.__name__,
                      "isResponse": f.is_response,
                      "originStageUid": f.origin_stage.uid if f.origin_stage else None,
                      "parentUids": [p.uid for p in f.parents]}
                     for f in features],
        "stages": [encode_stage(st, enc, full=not isinstance(st, Estimator))
                   for st in stages.values()],
        "fitted": {uid: encode_stage(t, enc, full=True)
                   for uid, t in model.fitted.items()},
    }
    with gzip.open(os.path.join(path, "model.json.gz"), "wt") as fh:
        json.dump(manifest, fh)
    np.savez_compressed(os.path.join(path, "arrays.npz"), **enc.arrays)

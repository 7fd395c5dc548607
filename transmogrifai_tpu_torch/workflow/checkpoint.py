"""Stage-granular training checkpoints — crash-resumable workflow fits
(counterpart of ``transmogrifai_tpu/workflow/checkpoint.py``).

Reference: the reference bounds recompute with ``persistEveryKStages`` RDD
persists (OpWorkflow.scala:412-417) and resumes across runs only via
whole-model save + ``withModelStages`` warm start.  This module checkpoints
each FITTED STAGE as it completes: a crashed or preempted ``train()`` re-run
skips every stage already on disk.

    ckpt = StageCheckpointer("/tmp/run1")
    model = workflow.train(checkpointer=ckpt)   # resumes automatically

Files: ``<dir>/<uid>.json`` + ``<uid>.npz``, in the format of the port's
``workflow/serde.py`` (the model save's).  A stage whose params (or whose
ancestors' params) changed refits, and so does every checkpointed
estimator downstream of a stage that refits; a torn or partial checkpoint
(a truncated ``.npz``, a corrupt ``.json``) refits that stage only.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..serve.faults import fault_point
from ..stages.base import PipelineStage, Transformer
from .serde import _Decoder, _Encoder, _register_stages, decode_stage, encode_stage

log = logging.getLogger(__name__)


def _stable_repr(v) -> str:
    """Deterministic-across-processes repr: callables hash by qualname (a plain
    repr embeds the memory address, which would invalidate every checkpoint on
    every resume)."""
    if callable(v):
        return getattr(v, "__qualname__", type(v).__name__)
    return repr(v)


def stage_fingerprint(stage: PipelineStage) -> str:
    """Class + params identity of the UNFITTED stage AND its upstream lineage —
    resume only reuses a checkpoint whose producing stage and every ancestor
    stage still look the same.  (Uids are a process-global construction counter;
    params can change between runs without changing the uid.)  Lineage coverage
    is what lets the cascade-invalidation pass treat stateless Transformers as
    non-refitting: a transformer param edit changes this fingerprint instead.
    FeatureGeneratorStages are skipped (extract fns have no stable identity;
    raw-feature names are already part of the input schema)."""
    from ..features.generator import FeatureGeneratorStage

    lineage = []
    seen = set()

    def walk(s):
        for f in getattr(s, "inputs", None) or ():
            o = f.origin_stage
            if o is None or o.uid in seen or isinstance(o, FeatureGeneratorStage):
                continue
            seen.add(o.uid)
            walk(o)
            lineage.append({"class": type(o).__name__, "params": o.get_params()})

    walk(stage)
    return json.dumps({"class": type(stage).__name__,
                       "params": stage.get_params(),
                       "lineage": lineage},
                      sort_keys=True, default=_stable_repr)


class StageCheckpointer:
    """Persists fitted stages by uid; loads them back as warm-start models.

    One directory == one logical run on one dataset: checkpoints carry the
    producing stage's class+params fingerprint (mismatches refit), but data
    identity is the caller's contract — point different datasets at different
    directories.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _paths(self, uid: str):
        safe = uid.replace(os.sep, "_")
        return (os.path.join(self.directory, f"{safe}.json"),
                os.path.join(self.directory, f"{safe}.npz"))

    def save_stage(self, model: Transformer,
                   fingerprint: Optional[str] = None) -> None:
        fault_point("checkpoint_write", stage=model.uid)
        enc = _Encoder()
        state = encode_stage(model, enc, full=True)
        if fingerprint is not None:
            state["stageFingerprint"] = fingerprint
        jpath, npath = self._paths(model.uid)
        tmp_j, tmp_n = jpath + ".tmp", npath + ".tmp"
        if enc.arrays:
            with open(tmp_n, "wb") as fh:
                np.savez(fh, **enc.arrays)
            os.replace(tmp_n, npath)
        elif os.path.exists(npath):
            # a refit whose new encoding has no arrays must not leave a previous
            # run's npz behind — load would pair new json with stale arrays
            os.remove(npath)
        with open(tmp_j, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp_j, jpath)  # json last: its presence marks completeness

    def load_entries(self) -> Dict[str, Tuple[Transformer, Optional[str]]]:
        """(fitted stage, saved fingerprint) by uid.  Unloadable checkpoints are
        skipped with a logged warning — a systematically failing decode (e.g. a
        stage class not imported) must be visible, not a silent full refit."""
        _register_stages()
        out: Dict[str, Tuple[Transformer, Optional[str]]] = {}
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".json"):
                continue
            jpath = os.path.join(self.directory, name)
            npath = jpath[:-5] + ".npz"
            try:
                with open(jpath) as fh:
                    state = json.load(fh)
                arrays = {}
                if os.path.exists(npath):
                    with np.load(npath, allow_pickle=False) as z:
                        arrays = {k: z[k] for k in z.files}
                stage = decode_stage(state, _Decoder(arrays))
                out[stage.uid] = (stage, state.get("stageFingerprint"))
            except Exception as e:
                log.warning("checkpoint %s not loadable (%s); that stage will "
                            "refit", name, e)
                continue
        return out

    def load_all(self) -> Dict[str, Transformer]:
        """All checkpointed fitted stages, keyed by uid."""
        return {uid: stage for uid, (stage, _) in self.load_entries().items()}

    def clear(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith((".json", ".npz")):
                os.remove(os.path.join(self.directory, name))

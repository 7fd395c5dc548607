"""OpParams — run configuration injected into workflows and stages
(counterpart of ``transmogrifai_tpu/params.py``, copied).

Reference: features/.../OpParams.scala:83-316 (stageParams keyed by class name or uid,
readerParams, model/metrics/write locations, customParams; fromFile/fromString
:300-308) and OpWorkflow.setStageParameters (OpWorkflow.scala:166-188) with the
"code wins over config" precedence rule (params already set in code are NOT overridden).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ReaderParams:
    """Per-reader configuration (path, partitions, custom)."""

    path: Optional[str] = None
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"path": self.path, "custom": self.custom}


@dataclass
class OpParams:
    """JSON/YAML-loadable run parameters."""

    #: stage class name or uid -> {param name: value}
    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    #: reader name -> ReaderParams
    reader_params: Dict[str, ReaderParams] = field(default_factory=dict)
    model_location: Optional[str] = None
    metrics_location: Optional[str] = None
    write_location: Optional[str] = None
    batch_duration_secs: int = 1
    custom_tag: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)
    #: log each stage's metrics as it completes (OpParams.scala:93-95)
    log_stage_metrics: bool = False
    #: collect per-stage metrics and export with run metrics
    collect_stage_metrics: bool = False
    #: directory for a profiler trace of the run
    profile_trace_dir: Optional[str] = None

    # -- loading -------------------------------------------------------------
    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpParams":
        readers = {
            k: ReaderParams(path=v.get("path"), custom=v.get("custom", {}))
            for k, v in d.get("readerParams", {}).items()
        }
        return OpParams(
            stage_params=d.get("stageParams", {}),
            reader_params=readers,
            model_location=d.get("modelLocation"),
            metrics_location=d.get("metricsLocation"),
            write_location=d.get("writeLocation"),
            batch_duration_secs=d.get("batchDurationSecs", 1),
            custom_tag=d.get("customTagName"),
            custom_params=d.get("customParams", {}),
            log_stage_metrics=d.get("logStageMetrics", False),
            collect_stage_metrics=d.get("collectStageMetrics", False),
            profile_trace_dir=d.get("profileTraceDir"),
        )

    @staticmethod
    def from_string(s: str) -> "OpParams":
        s = s.strip()
        if s.startswith("{"):
            return OpParams.from_dict(json.loads(s))
        # minimal YAML subset (2-level maps, scalars) so configs don't need pyyaml
        try:
            import yaml  # type: ignore

            return OpParams.from_dict(yaml.safe_load(s))
        except ImportError:
            return OpParams.from_dict(_parse_simple_yaml(s))

    @staticmethod
    def from_file(path: str) -> "OpParams":
        with open(path) as fh:
            return OpParams.from_string(fh.read())

    def to_dict(self) -> dict:
        return {
            "stageParams": self.stage_params,
            "readerParams": {k: v.to_dict() for k, v in self.reader_params.items()},
            "modelLocation": self.model_location,
            "metricsLocation": self.metrics_location,
            "writeLocation": self.write_location,
            "batchDurationSecs": self.batch_duration_secs,
            "customTagName": self.custom_tag,
            "customParams": self.custom_params,
            "logStageMetrics": self.log_stage_metrics,
            "collectStageMetrics": self.collect_stage_metrics,
            "profileTraceDir": self.profile_trace_dir,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)

    # -- injection (OpWorkflow.setStageParameters) ---------------------------
    def apply_to_stages(self, stages) -> Dict[str, Dict[str, Any]]:
        """Apply overrides; params set in code win.  Returns {uid: applied params}.

        Values applied from config are remembered per stage (``_config_set``) so a
        later config application can re-override them — only genuinely code-set
        params are protected (setattr routes through Param.__set__, which records
        into _param_values either way).
        """
        applied: Dict[str, Dict[str, Any]] = {}
        for stage in stages:
            for key in (type(stage).__name__, stage.uid):
                overrides = self.stage_params.get(key)
                if not overrides:
                    continue
                cls_params = stage._class_params()
                config_set = stage.__dict__.setdefault("_config_set", set())
                for name, value in overrides.items():
                    if name not in cls_params:
                        raise ValueError(
                            f"OpParams: stage {key} has no param {name!r} "
                            f"(valid: {sorted(cls_params)})")
                    if name in stage._param_values and name not in config_set:
                        continue  # code wins over config
                    setattr(stage, name, value)
                    config_set.add(name)
                    applied.setdefault(stage.uid, {})[name] = value
        return applied


def _parse_simple_yaml(s: str) -> Dict[str, Any]:
    """Tiny YAML subset: nested maps by indentation, scalar leaves.  Enough for
    OpParams files when pyyaml is unavailable."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]
    for raw in s.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, value = raw.strip().partition(":")
        value = value.strip()
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value == "":
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _yaml_scalar(value)
    return root


def _yaml_scalar(v: str) -> Any:
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~"):
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v.strip("\"'")

"""Converters between HyperParameters and Vizier study configs (port of
``cloud_tpu/tuner/vizier_utils.py``).

Reference analogue: ``tuner/utils.py`` (make_study_config :47-81,
convert_study_config_to_hps :84-158, parameter conversion incl. steps->
DISCRETE expansion :220-282, scale/goal mapping :285-357, trial->values
:374-388).
"""

from __future__ import annotations

from typing import Any, Dict, List

from cloud_tpu_torch.tuner import hyperparameters as hp_lib
from cloud_tpu_torch.tuner.engine import Objective

_SCALE = {"linear": "UNIT_LINEAR_SCALE", "log": "UNIT_LOG_SCALE"}
_SCALE_BACK = {v: k for k, v in _SCALE.items()}


def format_objective(objective) -> Objective:
    if isinstance(objective, Objective):
        return objective
    if isinstance(objective, str):
        direction = "min" if "loss" in objective else "max"
        return Objective(objective, direction)
    raise ValueError(f"Cannot interpret objective {objective!r}")


def make_study_config(objective, hps: hp_lib.HyperParameters) -> dict:
    """HyperParameters -> Vizier study_config (reference utils.py:47-81),
    with decay-curve automated stopping on by default (:63-68)."""
    obj = format_objective(objective)
    params: List[dict] = []
    for spec in hps.space:
        params.append(_convert_spec(spec))
    return {
        "algorithm": "ALGORITHM_UNSPECIFIED",
        "automatedStoppingConfig": {
            "decayCurveStoppingConfig": {"useElapsedTime": True}
        },
        "metrics": [
            {
                "metric": obj.name,
                "goal": "MINIMIZE" if obj.direction == "min" else "MAXIMIZE",
            }
        ],
        "parameters": params,
    }


def _convert_spec(spec) -> dict:
    if isinstance(spec, hp_lib.Choice):
        values = list(spec.values)
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in values):
            return {
                "parameter": spec.name,
                "type": "DISCRETE",
                "discreteValueSpec": {"values": [float(v) for v in values]},
            }
        return {
            "parameter": spec.name,
            "type": "CATEGORICAL",
            "categoricalValueSpec": {"values": [str(v) for v in values]},
        }
    if isinstance(spec, hp_lib.Int):
        if spec.step != 1:
            # steps -> DISCRETE expansion (reference utils.py:220-282)
            values = list(range(spec.min_value, spec.max_value + 1, spec.step))
            return {
                "parameter": spec.name,
                "type": "DISCRETE",
                "discreteValueSpec": {"values": [float(v) for v in values]},
            }
        return {
            "parameter": spec.name,
            "type": "INTEGER",
            "integerValueSpec": {
                "minValue": spec.min_value, "maxValue": spec.max_value
            },
            "scaleType": _SCALE[spec.sampling],
        }
    if isinstance(spec, hp_lib.Float):
        return {
            "parameter": spec.name,
            "type": "DOUBLE",
            "doubleValueSpec": {
                "minValue": spec.min_value, "maxValue": spec.max_value
            },
            "scaleType": _SCALE[spec.sampling],
        }
    if isinstance(spec, hp_lib.Boolean):
        return {
            "parameter": spec.name,
            "type": "CATEGORICAL",
            "categoricalValueSpec": {"values": ["True", "False"]},
        }
    if isinstance(spec, hp_lib.Fixed):
        return {
            "parameter": spec.name,
            "type": "CATEGORICAL",
            "categoricalValueSpec": {"values": [str(spec.value)]},
        }
    raise ValueError(f"Unknown hyperparameter spec {spec!r}")


def convert_study_config_to_hps(study_config: dict) -> hp_lib.HyperParameters:
    """Vizier study_config -> HyperParameters (reference utils.py:84-158)."""
    hps = hp_lib.HyperParameters()
    for param in study_config.get("parameters", []):
        name = param["parameter"]
        ptype = param["type"]
        if ptype == "DOUBLE":
            spec = param["doubleValueSpec"]
            hps.Float(
                name, spec["minValue"], spec["maxValue"],
                sampling=_SCALE_BACK.get(
                    param.get("scaleType", "UNIT_LINEAR_SCALE"), "linear"
                ),
            )
        elif ptype == "INTEGER":
            spec = param["integerValueSpec"]
            hps.Int(
                name, int(spec["minValue"]), int(spec["maxValue"]),
                sampling=_SCALE_BACK.get(
                    param.get("scaleType", "UNIT_LINEAR_SCALE"), "linear"
                ),
            )
        elif ptype == "DISCRETE":
            values = param["discreteValueSpec"]["values"]
            hps.Choice(name, values)
        elif ptype == "CATEGORICAL":
            values = param["categoricalValueSpec"]["values"]
            hps.Choice(name, values)
        else:
            raise ValueError(f"Unknown Vizier parameter type {ptype!r}")
    return hps


def convert_vizier_trial_to_values(vizier_trial: dict) -> Dict[str, Any]:
    """Vizier trial -> {name: value} (reference utils.py:374-388)."""
    values = {}
    for p in vizier_trial.get("parameters", []):
        if "floatValue" in p:
            values[p["parameter"]] = p["floatValue"]
        elif "intValue" in p:
            values[p["parameter"]] = int(p["intValue"])
        else:
            values[p["parameter"]] = p.get("stringValue")
    return values


def coerce_values(hps: hp_lib.HyperParameters, values: Dict[str, Any]) -> Dict[str, Any]:
    """Restore native Python types to service-suggested values.

    The Vizier wire format is lossy: Boolean/Fixed become CATEGORICAL
    strings and stepped Ints become DISCRETE floats.  Coercing against the
    *declared* space returns real bools/ints/originals — without this,
    ``if hp.Boolean("use_bias"):`` would always be truthy (the string
    "False").
    """
    out = dict(values)
    for spec in hps.space:
        if spec.name not in out:
            continue
        v = out[spec.name]
        if isinstance(spec, hp_lib.Boolean):
            out[spec.name] = v in (True, "True", "true", 1, "1")
        elif isinstance(spec, hp_lib.Fixed):
            out[spec.name] = spec.value
        elif isinstance(spec, hp_lib.Int):
            out[spec.name] = int(round(float(v)))
        elif isinstance(spec, hp_lib.Float):
            out[spec.name] = float(v)
        elif isinstance(spec, hp_lib.Choice):
            for candidate in spec.values:
                # Numeric candidates come back as DISCRETE doubles (64 ->
                # 64.0): == catches those; str() catches categorical strings.
                if candidate == v or str(candidate) == str(v):
                    out[spec.name] = candidate
                    break
    return out


def objective_from_study_config(study_config: dict) -> Objective:
    metric = study_config["metrics"][0]
    return Objective(
        metric["metric"],
        "min" if metric.get("goal") == "MINIMIZE" else "max",
    )

"""Model zoo (port of ``znicz_tpu/models``).  Each module sets its defaults
on the port's ``root`` config tree at import and exposes
``build_workflow(**overrides)``."""

import copy


def effective_config(node, defaults: dict):
    """DEFAULTS merged under the user's ``root`` overrides (deep copies, so
    builders that mutate the merged config never write into ``root`` or the
    module's DEFAULTS)."""
    from znicz_tpu_torch.core.config import Config

    cfg = Config(getattr(node, "_config_path_", ""))
    cfg.update(copy.deepcopy(defaults))
    cfg.update(copy.deepcopy(node.to_dict()))
    return cfg


def merge_workflow_kwargs(base: dict, overrides: dict) -> dict:
    """Merge caller overrides into a model's default workflow kwargs;
    dict-valued keys (decision_config) merge shallowly."""
    out = dict(base)
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = {**out[key], **value}
        else:
            out[key] = value
    return out

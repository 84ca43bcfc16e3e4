"""Model zoo (port of ``znicz_tpu/models``).  Each module sets its defaults
on the port's ``root`` config tree at import and exposes
``build_workflow(**overrides)``."""

import copy


def grayscale_image_dir_loader(
    data_dir: str,
    *,
    side: int,
    minibatch_size: int,
    normalization: str = "mean_disp",
):
    """The zoo's shared real-data path for image trees (Kanji, Yale Faces,
    the video autoencoder): ``train/<class>/*.png`` at side x side, grey,
    with mean-dispersion normalization fitted on the training images."""
    from znicz_tpu_torch.loader.image import ImageDirectoryLoader

    return ImageDirectoryLoader(
        data_dir,
        target_shape=(side, side, 1),
        grayscale=True,
        minibatch_size=minibatch_size,
        normalization=normalization,
    )


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


def translate_unsupervised_overrides(kwargs: dict, epochs_key: str) -> dict:
    """Map launcher-style overrides (``snapshot_dir``, ``decision_config``)
    onto the workflows that take a Snapshotter instance and a direct epochs
    kwarg (the SOM, the RBM, the LM)."""
    kwargs = dict(kwargs)
    snapshot_dir = kwargs.pop("snapshot_dir", None)
    if snapshot_dir:
        from znicz_tpu_torch.workflow.snapshotter import Snapshotter

        kwargs["snapshotter"] = Snapshotter(snapshot_dir, kwargs["name"])
    dc = kwargs.pop("decision_config", None)
    if dc:
        if "max_epochs" in dc:
            kwargs[epochs_key] = dc["max_epochs"]
        from znicz_tpu_torch.nn.decision import Decision

        # an epoch cap must always exist: the workflow's own budget unless
        # the caller set one
        dc_full = {"max_epochs": kwargs.get(epochs_key), **dc}
        kwargs.setdefault("decision", Decision(metric="loss", **dc_full))
    return kwargs

"""Image saver: dump worst/best classified samples per epoch (port of
``znicz_tpu/services/image_saver.py``).

After an evaluation pass, save the most-confidently-wrong and
most-confidently-right samples as PNGs
(``<dir>/epoch<N>/{worst,best}_<rank>_t<truth>_p<pred>.png``).  The
predictions come from ``model.predict`` on the workflow's device, under
``torch.no_grad()``: a per-epoch service, not hot-loop work.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class ImageSaver:
    def __init__(
        self,
        directory: str,
        *,
        split: str = "test",
        n_images: int = 8,
        every_n_epochs: int = 1,
    ):
        self.directory = directory
        self.split = split
        self.n_images = n_images
        self.every_n_epochs = every_n_epochs
        os.makedirs(directory, exist_ok=True)

    def on_epoch(self, workflow, verdict) -> None:
        epoch = workflow.decision.epoch - 1
        if epoch % self.every_n_epochs:
            return
        model = workflow.model
        if not hasattr(model, "predict") or workflow.loss_function != "softmax":
            return
        from znicz_tpu_torch.parallel import multihost

        if multihost.process_count() > 1:
            # services run on the coordinator only, but a single process can
            # neither run eager ops on globally-sharded params nor see the
            # other hosts' loader shards — a per-epoch sample dump is not
            # worth a collective, so the service declines once, loudly
            if not getattr(self, "_warned_multihost", False):
                self._warned_multihost = True
                workflow.warning(
                    "ImageSaver is disabled on multi-host runs (params span "
                    "hosts; each loader only serves its own shard)"
                )
            return
        xs, probs, labels = [], [], []
        # shuffle=False: a service pass must not advance the shuffle stream
        for mb in workflow.loader.batches(self.split, shuffle=False):
            with torch.no_grad():
                x = workflow._prep(workflow._put(mb.data), None)[0]
                p = model.predict(workflow.state.params, x)
            p = p.float().cpu().numpy()
            valid = mb.mask > 0
            xs.append(np.asarray(mb.data)[valid])
            probs.append(p[valid])
            labels.append(mb.labels[valid])
        if not xs:
            return
        x = np.concatenate(xs)
        p = np.concatenate(probs)
        y = np.concatenate(labels)
        pred = p.argmax(axis=1)
        # host-only diagnostic fancy indexing over already-fetched
        # predictions; the array never feeds a compiled program
        conf = p[np.arange(len(p)), pred]  # znicz-check: disable=ZNC014
        wrong = pred != y
        out_dir = os.path.join(self.directory, f"epoch{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        # worst: wrong with highest confidence; best: right with highest conf
        order_worst = np.argsort(-conf * wrong)[: self.n_images]
        order_best = np.argsort(-conf * ~wrong)[: self.n_images]
        for tag, order, keep in (
            ("worst", order_worst, wrong),
            ("best", order_best, ~wrong),
        ):
            for rank, i in enumerate(order):
                if not keep[i]:
                    continue
                self._save(
                    x[i],
                    os.path.join(
                        out_dir, f"{tag}_{rank}_t{y[i]}_p{pred[i]}.png"
                    ),
                )

    @staticmethod
    def _save(sample: np.ndarray, path: str) -> None:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        img = np.asarray(sample)
        if img.ndim == 1:
            n = int(np.sqrt(img.size))
            if n * n != img.size:
                return
            img = img.reshape(n, n)
        if img.ndim == 3 and img.shape[-1] == 1:
            img = img[..., 0]
        fig, ax = plt.subplots(figsize=(2, 2))
        ax.imshow(img, cmap="gray" if img.ndim == 2 else None)
        ax.axis("off")
        fig.savefig(path, dpi=72, bbox_inches="tight")
        plt.close(fig)

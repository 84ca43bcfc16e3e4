"""Interactive shell hook (port of ``znicz_tpu/interaction.py``).

Drop into an interactive Python shell mid-training to inspect or poke the
live workflow.  Attach as an epoch service:
``workflow.services.append(Shell(every_n_epochs=5))``; inside the shell,
``wf`` is the workflow, ``state`` its train state.
"""

from __future__ import annotations

import code
import sys


class Shell:
    def __init__(self, *, every_n_epochs: int = 1, enabled: bool = True):
        self.every_n_epochs = every_n_epochs
        self.enabled = enabled and sys.stdin.isatty()

    def on_epoch(self, workflow, verdict) -> None:
        epoch = workflow.decision.epoch - 1
        if not self.enabled or epoch % self.every_n_epochs:
            return
        banner = (
            f"znicz-tpu shell @ epoch {epoch} — locals: wf (workflow), "
            "state (train state), verdict; Ctrl-D to continue training"
        )
        code.interact(
            banner=banner,
            local={
                "wf": workflow,
                "state": workflow.state,
                "verdict": verdict,
            },
            exitmsg="resuming training",
        )

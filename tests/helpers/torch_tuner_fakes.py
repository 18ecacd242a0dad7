"""Fakes of the tuner tests (the port's copies of
``tests/unit/test_tuner.py``'s ``FakeSession`` and ``FakeTrainer``), plus
a file barrier that makes distributed-tuning workers meet once each holds
a trial, so no worker can find the budget spent before it starts."""

import os
import time


class FakeSession:
    """A scripted ``GcpApiSession``: each call must match the next
    ``(method and URL substring, response or exception)`` of ``script``;
    ``calls`` records ``(method, url, body, params)``."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def _dispatch(self, method, url, body=None, params=None):
        self.calls.append((method, url, body, params))
        if not self.script:
            return {}
        matcher, response = self.script.pop(0)
        assert matcher in f"{method} {url}", (matcher, method, url)
        if isinstance(response, Exception):
            raise response
        return response

    def post(self, url, body=None, params=None):
        return self._dispatch("POST", url, body, params)

    def get(self, url, params=None):
        return self._dispatch("GET", url, None, params)

    def delete(self, url):
        return self._dispatch("DELETE", url)


class FakeTrainer:
    """Quadratic objective: loss = (lr - 0.3)^2, reported per epoch."""

    def __init__(self, lr):
        self.lr = lr
        self.stop_training = False

    def fit(self, *, epochs=1, callbacks=(), **kw):
        for epoch in range(epochs):
            logs = {"loss": (self.lr - 0.3) ** 2 + 0.01 * epoch}
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs, self)
            if self.stop_training:
                break


def file_barrier(directory, name, parties, timeout=120.0):
    """Mark ``name`` arrived under ``directory`` and wait until
    ``parties`` names have."""
    os.makedirs(directory, exist_ok=True)
    open(os.path.join(directory, name), "w").close()
    deadline = time.monotonic() + timeout
    while len(os.listdir(directory)) < parties:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name}: {os.listdir(directory)} of "
                               f"{parties} arrived")
        time.sleep(0.01)


def barrier_hypermodel(directory, name, parties, build):
    """A hypermodel that meets the other workers at its first trial."""
    state = {"met": False}

    def hypermodel(hp):
        if not state["met"]:
            state["met"] = True
            file_barrier(directory, name, parties)
        return build(hp)

    return hypermodel

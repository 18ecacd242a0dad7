"""An autouse fixture for the port's tests that may install a SIGTERM
drain handler (``Trainer.fit``, the bootstrap, ``install_sigterm_handler``
of either package).

The handler stays installed after ``fit``, as in the JAX package; a test
worker that kept it would swallow the SIGTERM that ends a timed-out run.
After each test the previous handler comes back and both packages'
drain flags are cleared, so the next ``fit`` installs its own again.
Import it into a test module (``from helpers.torch_sigterm import
sigterm_restored``) to apply it to every test there.
"""

import signal
import sys
import threading

import pytest


@pytest.fixture(autouse=True)
def sigterm_restored():
    before = signal.getsignal(signal.SIGTERM)
    yield
    if threading.current_thread() is threading.main_thread():
        if signal.getsignal(signal.SIGTERM) is not before:
            signal.signal(signal.SIGTERM, before)
    for name in ("cloud_tpu_torch.training.preemption",
                 "cloud_tpu.training.preemption"):
        module = sys.modules.get(name)
        if module is not None:
            module.clear()
            module._installed = False

"""cloud_fit: serialize an in-memory training setup and fit it remotely (port
of ``cloud_tpu/cloud_fit/``).

The client serializes a :class:`serialization.TrainerSpec` (loss,
optimizer and init closures through cloudpickle), the arrays as npz and
the callbacks, and submits a job through the port's ``run()`` whose
container runs :func:`remote.run`: the port's ``Trainer`` fitted under the
planned mesh, its final state saved with the port's sharded checkpoints.

``cloud_tpu_torch.cloud_fit(...)`` calls :func:`client.cloud_fit`: the
root's lazy attribute is that function until this package is imported,
and then this package, which calls it too.
"""

import sys
import types

from cloud_tpu_torch.cloud_fit.client import cloud_fit

__all__ = ["cloud_fit"]


class _CallablePackage(types.ModuleType):
    """The package, callable as :func:`client.cloud_fit` (importing it
    rebinds the root's ``cloud_fit`` attribute to the package)."""

    def __call__(self, *args, **kwargs):
        return cloud_fit(*args, **kwargs)


sys.modules[__name__].__class__ = _CallablePackage

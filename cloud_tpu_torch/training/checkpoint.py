"""Asynchronous checkpoints with a durable-resume layer: integrity
manifests, verified walk-back restore, and composite iterator state (port
of ``cloud_tpu/training/checkpoint.py``).

The JAX package writes through Orbax; the port writes its own format and
keeps the Orbax policies the reference relies on:

* a save that is not ahead of the latest step is a no-op returning False;
  ``save_interval_steps`` applies by modulo (the first save always
  lands) unless ``force=True``, and a force at the latest step falls
  back to the plain call;
* ``max_to_keep`` keeps the newest steps;
* a step becomes visible in :meth:`CheckpointManager.steps` only once
  its write has completed: it is written into a temporary directory and
  renamed to its step number when the last file is on disk, so a kill
  mid-write leaves nothing that ``steps()`` lists.

**The format.** A step directory ``<root>/<step>/`` holds one raw file
per piece of a tensor leaf (``<n>.r<rank>.bin``, the piece's bytes in C
order; in one process a leaf is one piece) and ``index.json`` with the
tree: every dict, list, ``TrainState`` and None, and for each leaf its
key path, global shape, dtype, logical axes and its pieces (file and
bounds).  Nothing is pickled, so a restore runs no code from the
checkpoint; bf16 leaves round-trip bit for bit.

**Saving a state that is mutated in place.**  A JAX state is immutable,
so Orbax may read it after ``save`` returns.  The port's optimizer and a
window's CUDA graph overwrite the same tensors at the next step.  So the
blocking half of :meth:`CheckpointManager.save` takes a snapshot first:
each CUDA leaf is copied into a fresh pinned host buffer with a
``non_blocking`` copy on the current stream, in the stream's order before
any later step, and one event is recorded after the copies; a CPU leaf is
cloned.  The writer thread waits on the event before it reads the bytes,
and drops the buffers only once they are written.  At most one write is
in flight: the next ``save`` waits it out first.

**Durability** (the JAX package's ``docs/robustness.md`` "Durable
resume"):

* Every completed save gets a **manifest** (``manifest.cloud-tpu.json``
  inside the step dir): per-file byte size and streamed crc32 over every
  file of the step.  The manifest is written with an atomic rename, so
  its presence IS the commit marker.  Composite extras (iterator state)
  ride in a synchronous ``meta/`` sidecar that survives kills the
  manifest doesn't.
* Manifests are finalized when the write is known complete: at the NEXT
  ``save()`` (on a background thread), and at ``wait()``/``close()``.
  A hard kill between a save and its finalize leaves that step
  unmanifested (restorable, but not verified).
* :meth:`CheckpointManager.verify` replays the manifest against disk —
  ``"verified"`` / ``"corrupt"`` / ``"unmanifested"`` — and
  :func:`resume_trainer_state` **walks back** latest→older until an
  intact step restores, quarantining corrupt/partial step dirs.

**A state sharded over a mesh of several ranks** (one process per rank,
``parallel/``; :class:`StateLayout` says how each leaf lies: the mesh,
the parameters' logical axes and the rules) is saved per rank: each rank
writes the pieces of the leaves it holds, and a leaf replicated over
some mesh axes is written once, by the rank at coordinate 0 on those
axes.  In a job of several processes with no mesh every leaf is
replicated and process 0 writes it.  A manager given no layout under a
global mesh with a nontrivial axis other than ``dp`` refuses to save or
restore (it cannot tell a shard from a replica).  The ranks write into
one temporary directory, then meet (at the next ``save``, ``wait`` or
``close``); only the chief (``parallel.distributed.is_chief()``) writes
the index, renames the directory to its step, and writes the manifest,
which covers every rank's files, and the extras sidecar.  One process is
the case of one rank whose writer thread commits the step itself.  The index
records each leaf's global shape and dtype, its logical axes, the mesh
and the bounds of every piece in the global tensor
(``parallel.sharding.shard_bounds``).  A restore reads, on each rank,
only the pieces that cover that rank's slice, straight into it: the
same mesh, a one-process checkpoint restored into a mesh, and a mesh
checkpoint restored into one process are one mechanism.  Under several
ranks :func:`resume_trainer_state` lets the chief verify and pick the
step and broadcasts the choice, and a restore that fails on any rank
walks every rank back together.

**A ``gs://`` directory** (through the manager's ``storage_client``, else
``google.cloud.storage``; ``utils/gcs.py``) holds the same objects under
``<root>/<step>/``.  Object storage has no atomic rename, so every rank
uploads its pieces straight under the step's prefix and the chief uploads
``index.json`` last: a step whose index object is absent is never listed,
and the first save of a manager clears the pieces of such steps.  As in
the JAX package, a non-local directory gets no manifest (``verify()``
reads ``"unmanifested"``), no extras sidecar (``read_extras()`` returns
None, and ``CheckpointCallback(resume_data=True)`` warns) and no
quarantine move.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.parallel import distributed, sharding
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training.train import TrainState
from cloud_tpu_torch.utils import faults, gcs

logger = logging.getLogger(__name__)

#: The integrity manifest, inside each step dir.  Written via atomic
#: rename AFTER the write completes: presence == commit marker.
MANIFEST_NAME = "manifest.cloud-tpu.json"

#: Sidecar dir (under the checkpoint root) holding per-step composite
#: extras — iterator state and friends — written SYNCHRONOUSLY at save
#: time (they must reflect the trainer's position at that step, and they
#: are tiny).  Kept outside the step dir, which appears only once its
#: write completes.
META_DIRNAME = "meta"

#: Where corrupt/partial step dirs are moved (never deleted in place:
#: quarantined dirs keep the forensics while getting out of the resume
#: path).  Pruned to the manager's ``max_to_keep``.
QUARANTINE_DIRNAME = "quarantine"

#: The tree and the leaves' shapes and dtypes, inside each step dir.
INDEX_NAME = "index.json"

#: Prefix of a step's directory while it is written (not a number:
#: ``steps()`` never lists it).
TMP_PREFIX = ".tmp-"

_VERIFIED = "verified"
_CORRUPT = "corrupt"
_UNMANIFESTED = "unmanifested"


def _is_chief() -> bool:
    """Process 0 of the job writes what is written once (the index, the
    manifest, the extras), as the JAX package's checkpoints do."""
    return distributed.is_chief()


def _several_ranks() -> bool:
    """Whether this process is one of several in a ``torch.distributed``
    job: then saves and resumes are collective calls on every rank."""
    return distributed.process_count() > 1


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order (a collective call)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _from_chief(obj):
    """The chief's ``obj`` on every rank (a collective call)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """How a state's leaves lie on a mesh of several ranks: ``mesh`` (a
    ``parallel.mesh.Mesh``, or None), ``logical_axes`` (a tree congruent
    with the parameters, a leaf's axes a tuple, or None: every leaf
    replicated) and ``rules`` (``DEFAULT_RULES`` when None).  A leaf of
    the optimizer's state whose key path ends in a parameter's path and
    whose shape is that parameter's lies as the parameter does (SGD's
    ``trace``, Adam's ``mu`` and ``nu``); every other leaf is replicated.
    """

    mesh: Any = None
    logical_axes: Any = None
    rules: Any = None


def layout_of(trainer) -> StateLayout:
    """The layout of ``trainer``'s state: its mesh of more than one rank
    (None otherwise), logical axes and rules."""
    return StateLayout(mesh=getattr(trainer, "_mesh", None),
                       logical_axes=getattr(trainer, "logical_axes", None),
                       rules=getattr(trainer, "rules", None))


#: Streaming-read granularity for manifest hashing: bounds peak memory
#: at one chunk regardless of how large a leaf file is.
_HASH_CHUNK_BYTES = 8 * 1024 * 1024


def _file_crc32(path: str) -> "tuple":
    """(crc32, size) of a file, streamed in bounded chunks."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK_BYTES)
            if not chunk:
                return crc, size
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)


# -- the tree <-> files -------------------------------------------------------


def _flatten(tree, key: str, out: List[Tuple[str, Any]]) -> Dict:
    """The JSON spec of ``tree``; its leaves (key path, value) go to
    ``out`` in spec order."""
    if isinstance(tree, TrainState):
        return {"kind": "train_state", "fields": {
            f.name: _flatten(getattr(tree, f.name), f"{key}{f.name}/", out)
            for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        return {"kind": "dict", "items": {
            str(k): _flatten(v, f"{key}{k}/", out)
            for k, v in sorted(tree.items(), key=lambda kv: str(kv[0]))}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "list", "items": [
            _flatten(v, f"{key}{i}/", out) for i, v in enumerate(tree)]}
    if tree is None:
        return {"kind": "none"}
    out.append((key.rstrip("/"), tree))
    return {"kind": "leaf", "index": len(out) - 1}


def _leaf_tensor(value) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a checkpoint index")
    return dtype


def _join(directory: str, name: str) -> str:
    return (gcs.join(directory, name) if gcs.is_gcs(directory)
            else os.path.join(directory, name))


def _read_piece(step_dir: str, key: str, name: str, shape, dtype: torch.dtype,
                *, pin: bool, storage_client=None) -> torch.Tensor:
    """One piece of a leaf from its file (or ``gs://`` object), into pinned
    memory when ``pin`` (bound for the card); its size must be the
    index's."""
    shape = tuple(int(n) for n in shape)
    numel = int(np.prod(shape, dtype=np.int64))
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    path = _join(step_dir, name)
    data = (gcs.read_bytes(path, storage_client) if gcs.is_gcs(path)
            else None)
    size = len(data) if data is not None else os.path.getsize(path)
    if size != nbytes:
        raise ValueError(f"checkpoint leaf {key!r}: {path} holds "
                         f"{size} bytes, its index says {nbytes}")
    raw = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=pin)
    if data is not None:
        raw.numpy()[:] = np.frombuffer(data, np.uint8)
    elif nbytes:
        with open(path, "rb") as f:
            if f.readinto(memoryview(raw.numpy())) != nbytes:
                raise ValueError(f"checkpoint leaf {key!r}: short read")
    return raw.view(dtype).reshape(shape)


def _read_box(step_dir: str, entry: Dict, box, *, pin: bool,
              storage_client=None) -> torch.Tensor:
    """The part ``box`` (``[start, stop)`` per dim) of a leaf's global
    tensor, from the pieces that overlap it and no others."""
    dtype = _dtype(entry["dtype"])
    key = entry["key"]
    want = [e - b for b, e in box]
    if not all(want):
        return torch.empty(want, dtype=dtype, pin_memory=pin)
    out = None
    covered = 0
    for piece in entry["pieces"]:
        bounds = piece["bounds"]
        lo = [max(b, pb) for (b, _), (pb, _) in zip(box, bounds)]
        hi = [min(e, pe) for (_, e), (_, pe) in zip(box, bounds)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        value = _read_piece(step_dir, key, piece["file"],
                            [pe - pb for pb, pe in bounds], dtype, pin=pin,
                            storage_client=storage_client)
        if [list(b) for b in bounds] == [list(b) for b in box]:
            return value
        if out is None:
            out = torch.empty(want, dtype=dtype, pin_memory=pin)
        src = tuple(slice(l - pb, h - pb)
                    for l, h, (pb, _) in zip(lo, hi, bounds))
        dst = tuple(slice(l - b, h - b) for l, h, (b, _) in zip(lo, hi, box))
        out[dst] = value[src]
        covered += int(np.prod([h - l for l, h in zip(lo, hi)],
                               dtype=np.int64))
    if out is None or covered != int(np.prod(want, dtype=np.int64)):
        raise ValueError(f"checkpoint leaf {key!r}: its pieces do not cover "
                         f"{box} of its global shape {entry['shape']}")
    return out


def _leaf_axes(name: str, value, axes):
    """A parameter leaf's logical axes, as ``sharding.shard_tree`` reads
    them (a weight-only int8 leaf follows its float leaf's)."""
    if name in axes:
        return tuple(axes[name])
    if name.endswith("_q"):
        return tuple(axes[name[:-2]])
    if name.endswith("_scale"):
        return tuple(None if n == 1 else a
                     for n, a in zip(value.shape, axes[name[:-6]]))
    raise KeyError(f"no logical axes for param leaf {name!r}")


def _param_axes(params, axes, key: str, out: Dict, layout: StateLayout):
    """Each parameter leaf's key path (``_flatten``'s, under ``params/``)
    -> its logical axes."""
    if isinstance(axes, sharding.LayerStack):
        cut, _, _ = sharding.layer_stack_cut(
            layout.mesh, layout.rules or sharding.DEFAULT_RULES, len(axes))
        if cut:
            raise NotImplementedError(
                "a checkpoint of a state whose layer list is cut over "
                f"{cut} (a pipeline stage's block of layers) is not in the "
                "PyTorch port yet: it is queued under ROADMAP.md A.3")
    if isinstance(params, (list, tuple)):
        for i, (p, a) in enumerate(zip(params, axes)):
            _param_axes(p, a, f"{key}{i}/", out, layout)
        return out
    for name, value in params.items():
        if isinstance(value, (dict, list, tuple)):
            _param_axes(value, axes[name], f"{key}{name}/", out, layout)
        else:
            out[f"{key}{name}"] = (_leaf_axes(name, value, axes),
                                   tuple(_leaf_tensor(value).shape))
    return out


def _leaf_layouts(state, flat, layout: StateLayout) -> Dict[str, tuple]:
    """Key path -> ``(logical axes, {dim: mesh axes it is cut over})`` for
    each leaf of ``flat`` (``_flatten(state)``'s) that lies on the mesh
    as a parameter does; leaves missing from the result are
    replicated."""
    if (layout.mesh is None or layout.logical_axes is None
            or not isinstance(state, TrainState)):
        return {}
    rules = layout.rules or sharding.DEFAULT_RULES
    params = _param_axes(state.params, layout.logical_axes, "params/", {},
                         layout)
    by_rel = {k[len("params/"):]: v for k, v in params.items()}
    out = {}
    for key, value in flat:
        parts = key.split("/")
        if parts[0] == "params":
            found = params.get(key)
        elif parts[0] == "opt_state":
            shape = tuple(_leaf_tensor(value).shape)
            found = next((by_rel["/".join(parts[i:])]
                          for i in range(1, len(parts))
                          if by_rel.get("/".join(parts[i:]), (0, None))[1]
                          == shape), None)
        else:
            found = None
        if found is not None:
            cuts = sharding.split_dims(layout.mesh, found[0], rules)
            if cuts:
                out[key] = (found[0], cuts)
    return out


def _snapshot(state, layout: StateLayout):
    """The blocking half of a save: the tree spec, each leaf's index entry
    (global shape, dtype, logical axes and the bounds of every piece in
    the global tensor), the pieces this rank writes (``[(leaf, file)]``),
    a host copy of each (pinned, copied ``non_blocking`` in the current
    stream's order for a CUDA leaf; a clone for a CPU leaf), and the
    events recorded after the copies, one per device.

    A leaf cut over mesh axes is one piece per rank; a leaf replicated
    over some nontrivial axes is written by the ranks at coordinate 0 on
    them, and with no mesh by process 0.  Under several ranks every
    rank's local shapes are exchanged first (a collective call), so each
    knows the global shapes and every piece's bounds."""
    flat: List[Tuple[str, Any]] = []
    spec = _flatten(state, "", flat)
    cut = _leaf_layouts(state, flat, layout)
    mesh = layout.mesh
    tensors = [_leaf_tensor(v) for _, v in flat]
    me = {"coords": dict(mesh.coords) if mesh is not None else {},
          "shapes": [list(t.shape) for t in tensors]}
    everyone = _gather(me) if _several_ranks() else [me]
    rank = distributed.process_index()
    nontrivial = mesh.spec.nontrivial_axes() if mesh is not None else []
    entries, mine = [], []
    for i, ((key, _), t) in enumerate(zip(flat, tensors)):
        axes, cuts = cut.get(key, (None, {}))
        split = {a for c in cuts.values() for a in c}
        replicated = [a for a in nontrivial if a not in split]
        glob = list(t.shape)
        extents: Dict[int, Dict[int, int]] = {}
        for dim, c in cuts.items():
            extents[dim] = {}
            for other in everyone:
                count, index = sharding.shard_count_and_index(
                    mesh, c, coords=other["coords"])
                extents[dim][index] = other["shapes"][i][dim]
            glob[dim] = sum(extents[dim].get(j, 0) for j in range(count))
        pieces = []
        for r, other in enumerate(everyone):
            if not (r == 0 if mesh is None else all(
                    other["coords"].get(a, 0) == 0 for a in replicated)):
                continue
            bounds = [[0, n] for n in glob]
            for dim, c in cuts.items():
                _, index = sharding.shard_count_and_index(
                    mesh, c, coords=other["coords"])
                start = sum(extents[dim][j] for j in range(index))
                bounds[dim] = [start, start + extents[dim][index]]
            pieces.append({"file": f"{i}.r{r}.bin", "bounds": bounds})
            if r == rank:
                mine.append((i, f"{i}.r{r}.bin"))
        entries.append({"key": key, "shape": glob,
                        "dtype": _dtype_name(t.dtype),
                        "axes": None if axes is None else list(axes),
                        "pieces": pieces})
    buffers, devices = [], {}
    for i, _ in mine:
        t = tensors[i]
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            devices[t.device] = True
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        buffers.append(buf)
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return spec, entries, mine, buffers, events


def _target_box(entry: Dict, cuts, mesh, shape) -> list:
    """``[start, stop)`` per dim of this rank's slice of a leaf of global
    shape ``entry["shape"]``, cut as ``cuts`` says; raises if the
    template's local ``shape`` is not that slice's."""
    glob = [int(n) for n in entry["shape"]]
    box = [[0, n] for n in glob]
    for dim, axes in (cuts or {}).items():
        if dim >= len(glob):
            break
        count, index = sharding.shard_count_and_index(mesh, axes)
        box[dim] = list(sharding.shard_bounds(glob[dim], count, index))
    if [e - b for b, e in box] != list(shape):
        raise ValueError(
            f"checkpoint leaf {entry['key']!r} is {entry['dtype']}{glob}, "
            f"this rank's slice of it {[e - b for b, e in box]}, the "
            f"template's {list(shape)}")
    return box


def _kind(tree) -> str:
    if isinstance(tree, TrainState):
        return "train_state"
    if isinstance(tree, dict):
        return "dict"
    if isinstance(tree, (list, tuple)):
        return "list"
    return "none" if tree is None else "leaf"


#: ``_rebuild`` without a template.
_NO_TEMPLATE = object()

#: A template node whose saved subtree is not read (it comes back None).
_SKIP = object()


def _rebuild(spec, leaf_fn, template=_NO_TEMPLATE, key: str = ""):
    """The tree of ``spec`` with each leaf ``leaf_fn(index, template
    leaf)``; a template's structure must match the spec's, or it raises
    ``ValueError``."""
    if template is _SKIP:
        return None
    kind = spec.get("kind")
    where = key or "/"
    free = template is _NO_TEMPLATE
    if not free and _kind(template) != kind:
        raise ValueError(f"checkpoint holds a {kind} at {where!r}, the "
                         f"template a {_kind(template)}")
    if kind == "none":
        return None
    if kind == "leaf":
        return leaf_fn(spec["index"], None if free else template)
    if kind == "list":
        items = spec["items"]
        if not free and len(template) != len(items):
            raise ValueError(f"checkpoint list at {where!r} has "
                             f"{len(items)} items, the template's "
                             f"{len(template)}")
        return [_rebuild(s, leaf_fn, template if free else template[i],
                         f"{key}{i}/") for i, s in enumerate(items)]
    if kind == "dict":
        items = spec["items"]
        if free:
            return {k: _rebuild(s, leaf_fn, template, f"{key}{k}/")
                    for k, s in items.items()}
        if sorted(map(str, template)) != sorted(items):
            raise ValueError(f"checkpoint dict at {where!r} has keys "
                             f"{sorted(items)}, the template's "
                             f"{sorted(map(str, template))}")
        return {k: _rebuild(items[str(k)], leaf_fn, v, f"{key}{k}/")
                for k, v in template.items()}
    if kind == "train_state":
        return TrainState(**{
            name: _rebuild(s, leaf_fn, template if free
                           else getattr(template, name), f"{key}{name}/")
            for name, s in spec["fields"].items()})
    raise ValueError(f"unknown node {kind!r} in a checkpoint index")


class CheckpointManager:
    """Asynchronous saves of a state tree into numbered step directories,
    with the durability contract on top: integrity manifests with a
    commit marker, ``verify()``, quarantine of damaged step dirs, and
    composite per-step extras (iterator state).

    ``device`` is where a restore without a template puts its tensors
    (``cuda`` by default, ``"cpu"`` when asked); a restore with a
    template puts each leaf where the template's is.

    ``directory`` may be ``gs://`` (see the module's notes), read and
    written through ``storage_client`` (a ``google.cloud.storage.Client()``,
    built at first use, by default).

    ``layout`` (a :class:`StateLayout`) is how a state sharded over a mesh
    of several ranks lies; by default the installed global mesh with every
    leaf replicated, which only a mesh over ``dp`` alone (or none) takes:
    under any other nontrivial axis ``save`` and a templated ``restore``
    without a layout raise ``ValueError``.  In a job of several processes every rank constructs
    the manager and calls ``save``, ``wait`` and ``close`` together (they
    are collective calls); a save becomes visible in :meth:`steps` at the
    next of them.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, device=None,
                 layout: Optional[StateLayout] = None, storage_client=None):
        self._directory = os.fspath(directory)
        self._gcs = gcs.is_gcs(self._directory)
        self._storage_client = storage_client
        self._device = resolve_device(device)
        self._layout = layout
        #: The save in flight, not yet committed: ``(step, index,
        #: temporary dir)``.
        self._uncommitted: Optional[Tuple[int, Dict, str]] = None
        self._max_to_keep = max_to_keep
        self._save_interval_steps = max(1, int(save_interval_steps))
        #: Steps whose save was started but whose manifest has not been
        #: written yet (finalized at next save / wait / close).
        self._pending_manifest: List[int] = []
        #: In-flight background manifest hashing (started at a save
        #: boundary once the previous write is known complete, so the
        #: read+crc overlaps training; joined at the next boundary).
        self._finalize_thread: Optional[threading.Thread] = None
        #: The write in flight (at most one) and the error of the last
        #: one, raised by the next save() or wait().
        self._write_thread: Optional[threading.Thread] = None
        self._write_error: List[BaseException] = []
        self._wrote = False

    @property
    def directory(self) -> str:
        return self._directory

    def _client(self):
        if self._storage_client is None:
            self._storage_client = gcs.client()
        return self._storage_client

    def _step_dir(self, step: int) -> str:
        return _join(self._directory, str(int(step)))

    def _remove(self, path: str) -> None:
        """Delete a step directory (or prefix: its index object first, so
        the step stops being listed before its pieces go)."""
        if not self._gcs:
            shutil.rmtree(path, ignore_errors=True)
            return
        names = gcs.list_paths(path + "/", self._client())
        index = _join(path, INDEX_NAME)
        for name in sorted(names, key=lambda n: n != index):
            gcs.delete(name, self._client())

    def _meta_path(self, step: int) -> str:
        return os.path.join(self._directory, META_DIRNAME, f"{int(step)}.json")

    def _layout_for(self, layout: Optional[StateLayout]) -> StateLayout:
        if layout is not None:
            return layout
        if self._layout is not None:
            return self._layout
        mesh = mesh_lib.effective_mesh(mesh_lib.get_global_mesh())
        if mesh is not None and set(mesh.spec.nontrivial_axes()) - {"dp"}:
            raise ValueError(
                f"a checkpoint under the mesh {dict(mesh.spec.sizes)} needs "
                "to know how the state lies on it: pass the manager (or "
                "the call) layout=StateLayout(mesh, logical_axes, rules) "
                "(checkpoint.layout_of(trainer) for a Trainer's state); "
                "only under dp alone is every leaf replicated by default")
        return StateLayout(mesh=mesh)

    def _should_save(self, step: int, force: bool) -> bool:
        latest = self.latest_step()
        if latest is None:
            return True
        if step <= latest:
            return False
        return force or step % self._save_interval_steps == 0

    def _join_write(self, *, raise_error: bool = True) -> None:
        thread, self._write_thread = self._write_thread, None
        if thread is not None:
            thread.join()
        if raise_error and self._write_error:
            error = self._write_error.pop()
            raise error

    def save(self, step: int, state: Any, *, extras: Optional[Dict] = None,
             force: bool = False) -> bool:
        """Start an asynchronous save; returns whether it saved.

        ``extras`` is a small JSON-able dict saved alongside the step
        (composite checkpoint: the trainer's iterator state rides here)
        and handed back by :meth:`read_extras`.

        ``force=True`` bypasses ``save_interval_steps`` — the policy is
        modulo-based, so a save at an off-multiple step (a preemption
        drain's save, a fused-dispatch window that CROSSED the interval
        without landing on a multiple) would otherwise be skipped.  A
        force at the latest step falls back to the plain call.

        The span covers the blocking half: waiting out the PREVIOUS write
        (and joining its manifest hash, which had the whole inter-save
        interval to finish in the background) plus this save's snapshot
        — exactly the cost a training step pays at a save boundary.

        In a job of several processes every rank calls ``save`` with its
        own shards (laid out as the manager's ``layout`` says); the
        decision to save is the chief's, and the step is committed at the
        next ``save``, ``wait`` or ``close``.
        """
        step = int(step)
        with tracing.span("checkpoint/save", step=step):
            # Chaos seam: a crashed/hung save surfaces here — the same
            # place a full disk would.
            faults.fault_point("checkpoint.save")
            layout = self._layout_for(None)
            # The previous write must be committed before a new one
            # starts; waiting first means the steps handed to the
            # background finalize below have known-final files.
            self._commit()
            self._join_finalize()
            ready, self._pending_manifest = self._pending_manifest, []
            try:
                saved = self._decide(step, force)
                if saved:
                    self._start_write(step, state, layout)
            except BaseException:
                # This save failing must not drop the COMPLETED earlier
                # steps' manifests with it: put them back so the next
                # save/wait/close still commits them.
                self._pending_manifest = ready + self._pending_manifest
                raise
            if saved:
                self._write_meta(step, extras)
            if ready:
                # Hash + commit the completed earlier saves on a worker:
                # the lineage read must overlap training, not extend this
                # save's blocking half.
                self._start_finalize(ready)
            return saved

    def _decide(self, step: int, force: bool) -> bool:
        """Whether ``step`` is saved: the chief's decision, on every rank.
        Before the manager's first save the chief clears the temporary
        dirs a killed write left behind (no rank writes before the
        decision)."""
        decision = None
        if _is_chief():
            if not self._wrote:
                self._wrote = True
                self._clear_uncommitted()
            latest = self.latest_step()
            decision = self._should_save(
                step, force and not (latest is not None and step == latest))
        return bool(_from_chief(decision) if _several_ranks() else decision)

    def _clear_uncommitted(self) -> None:
        """Remove what killed writes left: the temporary directories, or
        on ``gs://`` the pieces of steps whose index was never uploaded."""
        if not self._gcs:
            for name in (os.listdir(self._directory)
                         if os.path.isdir(self._directory) else ()):
                if name.startswith(TMP_PREFIX):
                    shutil.rmtree(os.path.join(self._directory, name),
                                  ignore_errors=True)
            return
        root = self._directory.rstrip("/") + "/"
        listed = [p[len(root):] for p in gcs.list_paths(root, self._client())]
        committed = {n.split("/")[0] for n in listed
                     if n.count("/") == 1 and n.endswith("/" + INDEX_NAME)}
        for stale in sorted({n.split("/")[0] for n in listed if "/" in n}):
            if stale.isdigit() and stale not in committed:
                self._remove(_join(self._directory, stale))

    def _start_write(self, step: int, state: Any, layout: StateLayout) -> None:
        """Snapshot the pieces this rank writes (:func:`_snapshot`) and
        write them on a thread into the step's temporary directory.  In
        one process that thread then commits the step itself
        (:meth:`_commit_dir`); under several ranks the chief commits it
        when the ranks next meet (:meth:`_commit`)."""
        spec, entries, mine, buffers, events = _snapshot(state, layout)
        # On gs:// the pieces go straight under the step's prefix: the
        # index, uploaded last, is what makes the step appear.
        tmp = (self._step_dir(step) if self._gcs
               else os.path.join(self._directory, f"{TMP_PREFIX}{step}"))
        client = self._client() if self._gcs else None
        index = {"step": step, "tree": spec, "leaves": entries,
                 "mesh": (None if layout.mesh is None
                          else dict(layout.mesh.spec.sizes)),
                 "processes": distributed.process_count()}
        alone = not _several_ranks()
        self._uncommitted = (step, index, tmp)
        errors = self._write_error

        def write():
            try:
                for event in events:
                    event.synchronize()
                if client is None:
                    os.makedirs(tmp, exist_ok=True)
                for (_, name), buf in zip(mine, buffers):
                    data = (buf.reshape(-1).view(torch.uint8).numpy().data
                            if buf.numel() else b"")
                    if client is not None:
                        gcs.write_bytes(_join(tmp, name), data, client)
                        continue
                    with open(os.path.join(tmp, name), "wb") as f:
                        f.write(data)
                if alone:
                    self._commit_dir(step, index, tmp)
            except BaseException as exc:  # noqa: BLE001 — raised at commit
                if alone:
                    self._remove(tmp)
                errors.append(exc)

        thread = threading.Thread(target=write, daemon=True,
                                  name="cloud-tpu-ckpt-write")
        self._write_thread = thread
        thread.start()

    def _commit_dir(self, step: int, index: Dict, tmp: str) -> None:
        """Write the step's index into its temporary directory, rename
        that to the step (it appears whole or not at all) and keep the
        newest ``max_to_keep`` steps.  On ``gs://`` the pieces are already
        under the step's prefix, and uploading the index commits it."""
        if self._gcs:
            gcs.write_bytes(_join(tmp, INDEX_NAME),
                            json.dumps(index).encode(), self._client())
        else:
            with open(os.path.join(tmp, INDEX_NAME), "w",
                      encoding="utf-8") as f:
                json.dump(index, f)
            os.rename(tmp, self._step_dir(step))
        self._gc_steps()

    def _commit(self) -> None:
        """Commit the pending save, if any, and raise the error of a
        failed write.  In one process the writer thread committed it.
        Under several ranks each rank joins its own write, then all meet:
        the chief commits the step (:meth:`_commit_dir`), or removes it
        if any rank's write failed, which raises on every rank."""
        pending, self._uncommitted = self._uncommitted, None
        if not _several_ranks():
            self._join_write()
            if pending is not None:
                self._pending_manifest.append(pending[0])
            return
        error = None
        try:
            self._join_write()
        except Exception as exc:  # noqa: BLE001 — agreed on below
            error = f"rank {distributed.process_index()}: {exc!r}"
        errors = _gather(error)
        failure = None
        if _is_chief():
            failure = next((e for e in errors if e), None)
            if pending is not None:
                step, index, tmp = pending
                try:
                    if failure is not None:
                        raise RuntimeError(failure)
                    self._commit_dir(step, index, tmp)
                    self._pending_manifest.append(step)
                except Exception as exc:  # noqa: BLE001 — agreed on below
                    self._remove(tmp)
                    failure = failure or repr(exc)
        failure = _from_chief(failure)
        if failure is not None:
            raise RuntimeError(f"a checkpoint write failed: {failure}")

    def _gc_steps(self) -> None:
        """Keep the newest ``max_to_keep`` steps on disk."""
        if not self._max_to_keep:
            return
        for stale in self.steps()[:-self._max_to_keep]:
            self._remove(self._step_dir(stale))

    def restore(self, step: Optional[int] = None, *, template: Any = None,
                layout: Optional[StateLayout] = None):
        """The state saved at ``step`` (the latest by default).

        With a ``template`` (a state of the same structure, e.g. the
        trainer's own), each leaf comes back with the template's shape,
        dtype and device (and ``requires_grad``), and any mismatch in
        structure, shape or dtype raises ``ValueError``.  Under a mesh of
        several ranks (``layout``, by default the manager's) the template
        holds this rank's shards, and each leaf is read from the pieces
        that cover its slice of the global tensor, whatever mesh (or one
        process) saved it.  Without a template the saved tree comes back
        whole, its tensors on the manager's device.  A step whose files
        are damaged raises too."""
        cuts, mesh = {}, None
        if template is not None:
            layout = self._layout_for(layout)
            mesh = layout.mesh
        self._join_write(raise_error=False)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self._directory}")
        with tracing.span("checkpoint/restore", step=int(step)):
            faults.fault_point("checkpoint.restore")
            step_dir = self._step_dir(step)
            client = self._client() if self._gcs else None
            if client is not None:
                index = json.loads(gcs.read_bytes(_join(step_dir, INDEX_NAME),
                                                  client))
            else:
                with open(os.path.join(step_dir, INDEX_NAME),
                          encoding="utf-8") as f:
                    index = json.load(f)
            entries = index["leaves"]
            if template is not None:
                flat: List[Tuple[str, Any]] = []
                _flatten(template, "", flat)
                cuts = {k: c for k, (_, c) in
                        _leaf_layouts(template, flat, layout).items()}

            def leaf(i, like):
                entry = entries[i]
                if like is None:
                    full = [[0, int(n)] for n in entry["shape"]]
                    return _read_box(step_dir, entry, full, pin=False,
                                     storage_client=client).to(self._device)
                want = _leaf_tensor(like)
                box = _target_box(entry, cuts.get(entry["key"]), mesh,
                                  want.shape)
                value = _read_box(step_dir, entry, box,
                                  pin=want.device.type == "cuda",
                                  storage_client=client)
                if value.dtype != want.dtype:
                    raise ValueError(
                        f"checkpoint leaf {entry['key']!r} is "
                        f"{value.dtype}{list(value.shape)}, the template's "
                        f"{want.dtype}{list(want.shape)}")
                if not torch.is_tensor(like):
                    return value.numpy()
                value = value.to(want.device, non_blocking=True)
                return value.requires_grad_(like.requires_grad)

            return _rebuild(index["tree"], leaf,
                            _NO_TEMPLATE if template is None else template)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def steps(self) -> List[int]:
        """All completed step numbers on disk, ascending (re-read, so a
        quarantine or an out-of-band delete is reflected).  On ``gs://``
        a step is listed once its index object exists."""
        if self._gcs:
            root = self._directory.rstrip("/") + "/"
            names = [p[len(root):].split("/") for p in
                     gcs.list_paths(root, self._client())]
            return sorted(int(n[0]) for n in names
                          if len(n) == 2 and n[0].isdigit()
                          and n[1] == INDEX_NAME)
        try:
            names = os.listdir(self._directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isdir(
            os.path.join(self._directory, n)))

    def wait(self) -> None:
        """Wait for the write in flight, then commit every pending
        manifest: the durability barrier before a process may exit.
        Raises the error of a failed write.  In a job of several
        processes a collective call: every rank's write is committed
        (with its manifest) before any rank returns."""
        try:
            self._commit()
        finally:
            self._finalize_pending()
            if _several_ranks():
                _from_chief(None)

    def close(self) -> None:
        try:
            self.wait()
        except Exception:  # noqa: BLE001 — closing is best-effort
            logger.debug("wait-before-close failed", exc_info=True)

    # -- manifest / verify / quarantine ---------------------------------

    def _write_meta(self, step: int, extras: Optional[Dict]) -> None:
        """Synchronous tiny sidecar: the composite extras must reflect
        the trainer's position AT the save call, and must survive a hard
        kill even if the manifest never commits."""
        if not extras or self._gcs or not _is_chief():
            return
        try:
            meta_dir = os.path.join(self._directory, META_DIRNAME)
            os.makedirs(meta_dir, exist_ok=True)
            tmp = self._meta_path(step) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(extras, f)
            os.replace(tmp, self._meta_path(step))
        except Exception:  # noqa: BLE001 — extras are riders, not cargo
            logger.exception("could not write checkpoint extras for step %d",
                             step)

    def read_extras(self, step: int) -> Optional[Dict]:
        """The composite extras saved with ``step`` (None if absent)."""
        if self._gcs:
            return None
        try:
            with open(self._meta_path(step), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            logger.warning("unreadable checkpoint extras for step %d", step,
                           exc_info=True)
            return None

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), MANIFEST_NAME)

    def _join_finalize(self) -> None:
        thread, self._finalize_thread = self._finalize_thread, None
        if thread is not None:
            thread.join()

    def _start_finalize(self, steps: List[int]) -> None:
        # The meta prune must spare steps whose save is still in flight:
        # their dir has a temporary name until the write completes, but
        # their sidecar is already on disk.
        keep = frozenset(str(s) for s in steps) | frozenset(
            str(s) for s in self._pending_manifest
        )
        if self._uncommitted is not None:
            keep |= {str(self._uncommitted[0])}
        thread = threading.Thread(
            target=self._finalize_steps, args=(steps, keep), daemon=True,
            name="cloud-tpu-ckpt-manifest",
        )
        self._finalize_thread = thread
        thread.start()

    def _finalize_pending(self) -> None:
        """Synchronously commit every outstanding manifest."""
        self._join_finalize()
        pending, self._pending_manifest = self._pending_manifest, []
        self._finalize_steps(pending, frozenset(str(s) for s in pending))

    def _finalize_steps(self, pending: List[int],
                        keep: frozenset = frozenset()) -> None:
        """Write manifests for saves whose write has completed.

        A manifest that cannot be written leaves its step unmanifested
        (restorable, unverified) — never kills training.  A ``gs://``
        directory gets none (as in the JAX package).
        """
        if self._gcs or not _is_chief():
            return
        for step in pending:
            step_dir = self._step_dir(step)
            if not os.path.isdir(step_dir):
                continue  # save failed or was pruned already
            try:
                manifest = self._build_manifest(step, step_dir)
                # Chaos seam: a commit that dies here leaves the step
                # unmanifested — exactly what a kill at this instant does.
                faults.fault_point("checkpoint.commit")
                tmp = self._manifest_path(step) + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(manifest, f)
                os.replace(tmp, self._manifest_path(step))  # commit marker
            except Exception:  # noqa: BLE001 — durability layer must not
                # take training down; the step just stays uncommitted.
                logger.exception(
                    "could not commit manifest for checkpoint step %d", step
                )
        if pending:
            self._prune_meta(keep)

    def _build_manifest(self, step: int, step_dir: str) -> Dict:
        entries: Dict[str, Dict[str, int]] = {}
        for root, _dirs, files in os.walk(step_dir):
            for name in sorted(files):
                path = os.path.join(root, name)
                rel = os.path.relpath(path, step_dir)
                if rel == MANIFEST_NAME or rel == MANIFEST_NAME + ".tmp":
                    continue
                crc, size = _file_crc32(path)
                entries[rel] = {"bytes": size, "crc32": crc}
        return {"step": int(step), "committed": True, "entries": entries}

    def verify(self, step: int) -> str:
        """Replay the manifest against disk.

        Returns ``"verified"`` (manifest present, every entry's size and
        crc32 match), ``"corrupt"`` (manifest present but unreadable, an
        entry missing, or bytes changed), or ``"unmanifested"`` (no
        manifest — a save whose commit a hard kill interrupted, or a
        ``gs://`` directory).
        """
        status = self._verify_on_disk(step)
        # Chaos seam: a corrupt-mode rule can force any verdict.
        return faults.fault_point("checkpoint.verify", status)

    def _verify_on_disk(self, step: int) -> str:
        if self._gcs:
            return _UNMANIFESTED
        path = self._manifest_path(step)
        if not os.path.exists(path):
            return _UNMANIFESTED
        try:
            with open(path, encoding="utf-8") as f:
                manifest = json.load(f)
            entries = manifest["entries"]
        except (OSError, ValueError, KeyError):
            logger.warning("unreadable manifest for step %d", step,
                           exc_info=True)
            return _CORRUPT
        step_dir = self._step_dir(step)
        for rel, want in entries.items():
            file_path = os.path.join(step_dir, rel)
            try:
                crc, size = _file_crc32(file_path)
            except OSError:
                logger.warning("checkpoint step %d: missing entry %r",
                               step, rel)
                return _CORRUPT
            if size != want.get("bytes"):
                logger.warning(
                    "checkpoint step %d: %r is %d bytes, manifest says %s",
                    step, rel, size, want.get("bytes"),
                )
                return _CORRUPT
            if crc != want.get("crc32"):
                logger.warning("checkpoint step %d: %r fails its manifest "
                               "crc32", step, rel)
                return _CORRUPT
        return _VERIFIED

    def quarantine(self, step: int) -> bool:
        """Move a damaged step dir out of the resume path.

        The dir lands under ``quarantine/`` (kept for forensics, pruned
        to ``max_to_keep`` entries oldest-first).  Removing a walked-past
        step from the lineage is load-bearing, not hygiene: a save not
        ahead of ``latest_step`` is skipped, so a stale newer dir left in
        place would silently disable every checkpoint save of the resumed
        job until it passed that step.  A ``gs://`` step is never moved
        (returns False), as in the JAX package.
        """
        step_dir = self._step_dir(step)
        if self._gcs or not os.path.isdir(step_dir):
            return False
        qdir = os.path.join(self._directory, QUARANTINE_DIRNAME)
        try:
            os.makedirs(qdir, exist_ok=True)
            dst = os.path.join(
                qdir, f"step-{int(step)}-{int(time.time() * 1000)}"
            )
            shutil.move(step_dir, dst)
        except OSError:
            logger.exception("could not quarantine checkpoint step %d; "
                             "deleting instead", step)
            try:
                shutil.rmtree(step_dir)
            except OSError:
                logger.exception("could not delete checkpoint step %d", step)
                return False
        metrics.counter_inc("checkpoint/quarantined")
        try:
            meta = self._meta_path(step)
            if os.path.exists(meta):
                os.remove(meta)
        except OSError:
            logger.debug("meta cleanup failed for step %d", step,
                         exc_info=True)
        self._gc_quarantine(qdir)
        logger.warning("quarantined checkpoint step %d under %s", step, qdir)
        return True

    def _gc_quarantine(self, qdir: str) -> None:
        # Prune by QUARANTINE time, not dir mtime: shutil.move preserves
        # the step dir's original mtime, so an ancient step quarantined
        # just now would sort oldest and delete the very forensics being
        # collected.  quarantine() embeds its wall-clock (ms) in the dst
        # name; dirs without the suffix fall back to mtime (same unit).
        def _quarantined_at(entry: str) -> float:
            tail = entry.rsplit("-", 1)[-1]
            if tail.isdigit():
                return float(tail)
            return os.path.getmtime(os.path.join(qdir, entry)) * 1000.0

        try:
            entries = sorted(
                (e for e in os.listdir(qdir)
                 if os.path.isdir(os.path.join(qdir, e))),
                key=_quarantined_at,
            )
            for stale in entries[:-self._max_to_keep or None]:
                shutil.rmtree(os.path.join(qdir, stale), ignore_errors=True)
        except OSError:
            logger.debug("quarantine GC failed", exc_info=True)

    def _prune_meta(self, keep: frozenset = frozenset()) -> None:
        """Drop extras sidecars for steps no longer on disk (the
        ``max_to_keep`` prune removes the step dirs; the riders go with
        them).  ``keep`` lists steps whose write may not have completed
        yet but whose sidecar is already written."""
        meta_dir = os.path.join(self._directory, META_DIRNAME)
        if not os.path.isdir(meta_dir):
            return
        try:
            live = {name for name in os.listdir(self._directory)
                    if name.isdigit()} | set(keep)
            for name in os.listdir(meta_dir):
                stem, ext = os.path.splitext(name)
                if ext == ".json" and stem not in live:
                    os.remove(os.path.join(meta_dir, name))
        except OSError:
            logger.debug("meta prune failed", exc_info=True)


def _note_fallback(step: int, reason: str) -> None:
    metrics.counter_inc("checkpoint/fallbacks")
    now = time.perf_counter()
    tracing.record_span("checkpoint/fallback", now, now, step=int(step),
                        reason=reason)


def resume_trainer_state(trainer, manager: CheckpointManager, *,
                         only_if_ahead: bool = True,
                         apply_data_state: bool = False,
                         quarantine: bool = True) -> bool:
    """Restore the newest INTACT checkpoint into ``trainer.state``.

    The ONE shared resume recipe (used by :class:`CheckpointCallback`
    and the non-finite rollback path).  Candidates are walked
    latest→older:

    * a step whose manifest fails :meth:`CheckpointManager.verify` is
      quarantined and skipped (``checkpoint/fallbacks`` counter +
      ``checkpoint/fallback`` span each time);
    * an unmanifested step (a commit a hard kill interrupted) is restored
      optimistically; if the restore raises it is quarantined as a
      partial write and the walk continues;
    * a VERIFIED step whose restore still raises (template mismatch, a
      transient) is quarantined too — its bytes stay available under
      ``quarantine/``, but it cannot stay in the lineage: a save not
      ahead of ``latest_step`` is skipped, so a walked-past step left in
      place would turn every later save into a no-op.

    Only when every candidate fails does the function log "starting
    fresh" and return False.

    The restore template is the trainer's own state, so each leaf keeps
    its shape, dtype and device; a window's CUDA graph then copies the
    restored values into its static buffers at its next call.  Under a
    mesh of several ranks (the trainer's layout, :func:`layout_of`) each
    rank restores straight into its shards.  In
    a job of several processes every rank calls this together: the
    chief lists the candidates and verifies each (and quarantines), the
    choice is broadcast, and a restore that fails on any rank walks every
    rank back to the same older step.  A stochastic state's rng chain
    restores bit-exactly when the checkpoint carries it; a checkpoint of
    the other ``stochastic`` setting restores the rest, the trainer's key
    carried forward (:func:`_restore_matching_rng`).

    ``only_if_ahead`` (the preemption-recovery default) skips checkpoints
    not ahead of the current state; False lets a state saved at step 0
    (pretrained weights) replace a fresh init.

    ``apply_data_state=True`` additionally hands the checkpoint's saved
    iterator state (:meth:`CheckpointManager.read_extras`) to the
    trainer (``trainer._resume_data_state``), so the next ``fit()``
    resumes the data stream exactly where the restored step left it.

    ``quarantine=False`` makes the walk-back purely read-only: failed
    candidates are skipped (counted + spanned) but never moved — for a
    directory the caller does not own, such as a benchmark probe's.
    """
    if trainer.state is None:
        return False
    current = trainer.state
    current_step = int(current.step)
    layout = layout_of(trainer)
    ranks = _several_ranks()
    chief = _is_chief()
    agree = _from_chief if ranks else (lambda value: value)
    candidates = None
    if chief:
        try:
            candidates = [
                s for s in sorted(manager.steps(), reverse=True)
                if not (only_if_ahead and s <= current_step)
            ]
        except Exception:  # noqa: BLE001 — unreadable dir: fresh start
            logger.exception("could not list checkpoints in %r",
                             manager.directory)
    candidates = agree(candidates)
    if not candidates:
        return False
    for step in candidates:
        status = None
        if chief:
            try:
                status = manager.verify(step)
            except Exception:  # noqa: BLE001 — chaos or IO error in verify
                logger.exception("checkpoint verify raised at step %d; "
                                 "skipping it", step)
                status = "verify_error"
        status = agree(status)
        if status in ("verify_error", _CORRUPT):
            if status == _CORRUPT:
                logger.error(
                    "checkpoint step %d failed integrity verification; "
                    "walking back", step,
                )
            _note_fallback(step, "corrupt" if status == _CORRUPT
                           else status)
            if quarantine and chief:
                manager.quarantine(step)
            continue
        error = None
        try:
            restored = _restore_matching_rng(manager, step, current, layout)
        except Exception as exc:  # noqa: BLE001 — walk back instead of dying
            logger.exception(
                "could not restore checkpoint step %d (%s); walking back",
                step, status,
            )
            error = repr(exc)
        failed = (any(e is not None for e in _gather(error)) if ranks
                  else error is not None)
        if failed:
            if error is None:
                logger.error("checkpoint step %d failed to restore on "
                             "another rank; walking back", step)
            _note_fallback(step, "restore_failed")
            if quarantine and chief:
                manager.quarantine(step)
            continue
        trainer.state = restored
        if apply_data_state:
            extras = manager.read_extras(step) or {}
            data_state = extras.get("data_state")
            if isinstance(data_state, dict):
                trainer._resume_data_state = dict(data_state)
        if current_step == 0 and only_if_ahead:
            logger.warning(
                "resumed from checkpoint step %d in %r, REPLACING this "
                "run's fresh step-0 state; if this is a new experiment "
                "reusing an old directory, pass resume=False (or clear "
                "the directory)", step, manager.directory,
            )
        else:
            logger.info("resumed from checkpoint step %d (%s)", step, status)
        return True
    logger.error(
        "no intact checkpoint in %r (%d candidate(s) failed verification "
        "or restore); starting fresh", manager.directory, len(candidates),
    )
    return False


def _restore_matching_rng(manager: CheckpointManager, step: int,
                          current: TrainState, layout: StateLayout):
    """Restore ``step`` into the current state's structure.

    A stochastic state (``current.rng`` not None) first tries the full
    template, so the saved rng chain comes back bit-exact; a checkpoint
    written without the rng leaf (the other ``stochastic`` setting)
    restores with the fresh state's key carried forward.  A deterministic
    state skips a saved rng leaf.  The JAX package's contract."""
    try:
        return manager.restore(step, template=current, layout=layout)
    except ValueError:
        logger.info("checkpoint step %d restore with the full template "
                    "failed; retrying without its rng leaf", step,
                    exc_info=True)
    restored = manager.restore(
        step, template=dataclasses.replace(
            current, rng=None if current.rng is not None else _SKIP),
        layout=layout)
    restored.rng = current.rng
    return restored


class CheckpointCallback:
    """Trainer callback: save every N steps and at train end.

    ``resume=True`` (default) restores the newest intact checkpoint into
    ``trainer.state`` at train begin when one exists AND is ahead of the
    current state — the preemption-recovery contract: a recreated node
    re-runs the same script, whose fresh state is at step 0, and training
    continues from the last save.  A corrupt newest checkpoint walks back
    to an older intact one (:func:`resume_trainer_state`).

    ``resume_data=True`` opts into the exactly-once composite resume:
    each save carries the trainer's iterator position (epoch +
    consumed-batch index, counted at the trainer boundary) and a resumed
    ``fit()`` continues the data stream bit-exactly from the restored
    step, finishing the ORIGINAL epochs budget instead of running
    ``epochs`` fresh ones.

    ``device`` and ``storage_client`` are the manager's (see
    :class:`CheckpointManager`).
    """

    def __init__(self, directory: str, *, every_n_steps: int = 100,
                 max_to_keep: int = 3, resume: bool = True,
                 resume_data: bool = False, device=None,
                 storage_client=None):
        self.directory = directory
        self.every_n_steps = every_n_steps
        self.max_to_keep = max_to_keep
        self.resume = resume
        self.resume_data = resume_data
        self.device = device
        self.storage_client = storage_client
        self._manager: Optional[CheckpointManager] = None
        #: Last step observed by on_step_end — fused dispatch (k>1)
        #: reports only window-boundary steps, so the periodic trigger
        #: fires on interval CROSSINGS, not on exact multiples.
        self._prev_step: Optional[int] = None

    # Lazily create the manager so the callback object stays picklable
    # before/after training (managers hold threads).
    def _get(self, trainer=None) -> CheckpointManager:
        """The manager, built at first use with ``trainer``'s layout (its
        mesh, logical axes and rules: :func:`layout_of`)."""
        if self._manager is None:
            self._manager = CheckpointManager(
                self.directory, max_to_keep=self.max_to_keep,
                save_interval_steps=self.every_n_steps, device=self.device,
                layout=None if trainer is None else layout_of(trainer),
                storage_client=self.storage_client,
            )
        return self._manager

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_manager"] = None
        return state

    def _reset_manager_after_failure(self) -> None:
        """Count the failure, close best-effort, rebuild lazily on the
        next use (the reference's Orbax managers can wedge after a failed
        save; the port keeps the same recovery)."""
        metrics.counter_inc("checkpoint/save_failures")
        manager, self._manager = self._manager, None
        try:
            if manager is not None:
                manager.close()
        except Exception:  # noqa: BLE001 — already failing
            logger.debug("failed manager close", exc_info=True)

    @staticmethod
    def _extras(trainer) -> Optional[Dict]:
        data_state = getattr(trainer, "data_state", None)
        if not isinstance(data_state, dict):
            return None
        return {"data_state": dict(data_state)}

    def on_train_begin(self, trainer):
        if self.resume_data and gcs.is_gcs(self.directory):
            # The meta/ sidecar carrying iterator state is local-fs only
            # (like the manifests): on a non-local directory the composite
            # resume silently loses its data half — say so loudly instead.
            logger.warning(
                "CheckpointCallback(resume_data=True) on non-local %r: "
                "iterator state is NOT saved or restored there — a resumed "
                "fit restarts the data stream (exactly-once resume needs a "
                "local checkpoint directory)", self.directory,
            )
        if self.resume and trainer.state is not None:
            resume_trainer_state(trainer, self._get(trainer),
                                 apply_data_state=self.resume_data)
        # Arm the interval-crossing detector AFTER a possible restore, so
        # a resumed run measures crossings from its restored step.
        self._prev_step = (
            int(trainer.state.step) if trainer.state is not None else None
        )

    def on_epoch_begin(self, epoch, trainer): ...

    def on_step_end(self, step, logs, trainer):
        # Fire when the interval was CROSSED, not only on exact
        # multiples: a fused dispatch (steps_per_dispatch=k) reports
        # steps k apart, and the modulo check alone would silently
        # degrade the save cadence to lcm(k, every_n_steps).
        prev, self._prev_step = self._prev_step, step
        every = self.every_n_steps
        on_multiple = step % every == 0
        crossed = on_multiple or (
            prev is not None and step // every > prev // every
        )
        if crossed:
            try:
                # force: an off-multiple crossing step would be skipped
                # by the modulo interval policy.
                self._get(trainer).save(step, trainer.state,
                                 extras=self._extras(trainer),
                                 force=not on_multiple)
            except Exception:  # noqa: BLE001 — a periodic save is
                # redundancy, not the product: a transient failure must
                # not kill a healthy training job.  The next interval —
                # and the mandatory train-end save — retry with a fresh
                # manager; only those remaining failures are fatal.
                logger.exception(
                    "periodic checkpoint save at step %d failed; training "
                    "continues (next save at step %d)",
                    step, step + self.every_n_steps,
                )
                self._reset_manager_after_failure()

    def on_epoch_end(self, epoch, logs, trainer): ...

    def rollback_state(self, trainer) -> bool:
        """Restore the newest intact checkpoint into ``trainer.state``,
        even if it is BEHIND the current step — the trainer's non-finite
        quarantine calls this to rewind a diverged run to its last
        verified state (the data stream keeps its current position: the
        batches that diverged it are not replayed)."""
        try:
            manager = self._get(trainer)
            manager.wait()  # an in-flight save must land first
            return resume_trainer_state(
                trainer, manager, only_if_ahead=False, apply_data_state=False
            )
        except Exception:  # noqa: BLE001 — the caller terminates instead
            logger.exception("rollback restore failed")
            return False

    def on_train_end(self, trainer):
        state = getattr(trainer, "state", None)
        if state is None:
            # A fit aborted before producing state still drains through
            # on_train_end; dying HERE would mask the original failure.
            logger.warning(
                "CheckpointCallback.on_train_end: trainer has no state "
                "(fit aborted before producing one); skipping final save"
            )
            return
        # The train-end save is the preemption drain's one shot at not
        # losing work: a single transient failure gets one retry with a
        # fresh manager before it is allowed to take the job down.
        extras = self._extras(trainer)
        try:
            manager = self._get(trainer)
            # force: the drain/final step is rarely a multiple of
            # every_n_steps, and the modulo interval policy would skip it.
            manager.save(int(state.step), state, extras=extras, force=True)
        except Exception:  # noqa: BLE001 — retried once, then strict
            logger.exception(
                "train-end checkpoint save failed; retrying once with a "
                "fresh manager"
            )
            self._reset_manager_after_failure()
            manager = self._get(trainer)
            manager.save(int(state.step), state, extras=extras, force=True)
        manager.wait()
        manager.close()
        self._manager = None

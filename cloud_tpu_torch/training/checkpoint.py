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
per tensor leaf (``<n>.bin``, the leaf's bytes in C order) and
``index.json`` with the tree: every dict, list, ``TrainState`` and None,
and for each leaf its key path, shape, dtype and file.  Nothing is
pickled, so a restore runs no code from the checkpoint; bf16 leaves
round-trip bit for bit.

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

Directories on ``gs://`` wait for the cloud layers and raise
``NotImplementedError`` (ROADMAP.md A.6).
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

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.training.train import TrainState
from cloud_tpu_torch.utils import faults

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

_GCS_LATER = ("checkpoints on gs:// are not ported yet: they come with the "
              "cloud layers (ROADMAP.md A.6)")


def _is_chief() -> bool:
    """One process until ``parallel/*`` is ported (ROADMAP.md A.6)."""
    return True


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


def _snapshot(state) -> Tuple[Dict, List[Dict], List[torch.Tensor], list]:
    """The blocking half of a save: the tree spec, each leaf's index entry,
    a host copy of each leaf (pinned, copied ``non_blocking`` in the
    current stream's order for a CUDA leaf; a clone for a CPU leaf), and
    the events recorded after the copies, one per device."""
    flat: List[Tuple[str, Any]] = []
    spec = _flatten(state, "", flat)
    entries, buffers, devices = [], [], {}
    for i, (key, value) in enumerate(flat):
        t = _leaf_tensor(value)
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            devices[t.device] = True
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        buffers.append(buf)
        entries.append({"key": key, "file": f"{i}.bin",
                        "shape": list(t.shape), "dtype": _dtype_name(t.dtype)})
    events = []
    for device in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append(event)
    return spec, entries, buffers, events


def _write_step(step_dir: str, tmp: str, step: int, spec, entries, buffers,
                events) -> None:
    """The writer thread's half: wait for the snapshot's copies, write
    each leaf and the index into ``tmp``, then rename it to ``step_dir``
    (the step appears whole or not at all)."""
    for event in events:
        event.synchronize()
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for entry, buf in zip(entries, buffers):
        with open(os.path.join(tmp, entry["file"]), "wb") as f:
            if buf.numel():
                f.write(buf.reshape(-1).view(torch.uint8).numpy().data)
    with open(os.path.join(tmp, INDEX_NAME), "w", encoding="utf-8") as f:
        json.dump({"step": int(step), "tree": spec, "leaves": entries}, f)
    os.rename(tmp, step_dir)


def _read_leaf(step_dir: str, entry: Dict, *, pin: bool) -> torch.Tensor:
    """One leaf from its file, into pinned memory when ``pin`` (bound for
    the card); its size must be the index's."""
    shape = tuple(int(n) for n in entry["shape"])
    dtype = _dtype(entry["dtype"])
    numel = int(np.prod(shape, dtype=np.int64))
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    path = os.path.join(step_dir, entry["file"])
    size = os.path.getsize(path)
    if size != nbytes:
        raise ValueError(f"checkpoint leaf {entry['key']!r}: {path} holds "
                         f"{size} bytes, its index says {nbytes}")
    raw = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=pin)
    if nbytes:
        with open(path, "rb") as f:
            if f.readinto(memoryview(raw.numpy())) != nbytes:
                raise ValueError(
                    f"checkpoint leaf {entry['key']!r}: short read")
    return raw.view(dtype).reshape(shape)


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


def _rebuild(spec, leaf_fn, template=_NO_TEMPLATE, key: str = ""):
    """The tree of ``spec`` with each leaf ``leaf_fn(index, template
    leaf)``; a template's structure must match the spec's, or it raises
    ``ValueError``."""
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
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, device=None):
        self._directory = os.fspath(directory)
        if self._directory.startswith("gs://"):
            raise NotImplementedError(_GCS_LATER)
        self._device = resolve_device(device)
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

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(int(step)))

    def _meta_path(self, step: int) -> str:
        return os.path.join(self._directory, META_DIRNAME, f"{int(step)}.json")

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
        """
        step = int(step)
        with tracing.span("checkpoint/save", step=step):
            # Chaos seam: a crashed/hung save surfaces here — the same
            # place a full disk would.
            faults.fault_point("checkpoint.save")
            # The previous write must be complete before a new one
            # starts; waiting first means the steps handed to the
            # background finalize below have known-final files.
            self._join_write()
            self._join_finalize()
            ready, self._pending_manifest = self._pending_manifest, []
            latest = self.latest_step()
            if force and latest is not None and step == latest:
                force = False
            try:
                saved = self._should_save(step, force)
                if saved:
                    self._start_write(step, state)
            except BaseException:
                # This save failing must not drop the COMPLETED earlier
                # steps' manifests with it: put them back so the next
                # save/wait/close still commits them.
                self._pending_manifest = ready + self._pending_manifest
                raise
            if saved:
                self._write_meta(step, extras)
                self._pending_manifest.append(step)
            if ready:
                # Hash + commit the completed earlier saves on a worker:
                # the lineage read must overlap training, not extend this
                # save's blocking half.
                self._start_finalize(ready)
            return saved

    def _start_write(self, step: int, state: Any) -> None:
        spec, entries, buffers, events = _snapshot(state)
        os.makedirs(self._directory, exist_ok=True)
        if not self._wrote:
            # A write a kill interrupted left its temporary dir behind.
            self._wrote = True
            for name in os.listdir(self._directory):
                if name.startswith(TMP_PREFIX):
                    shutil.rmtree(os.path.join(self._directory, name),
                                  ignore_errors=True)
        step_dir = self._step_dir(step)
        tmp = os.path.join(self._directory,
                           f"{TMP_PREFIX}{step}-{os.getpid()}")
        errors = self._write_error

        def write():
            try:
                _write_step(step_dir, tmp, step, spec, entries, buffers,
                            events)
                self._gc_steps()
            except BaseException as exc:  # noqa: BLE001 — raised at wait
                shutil.rmtree(tmp, ignore_errors=True)
                errors.append(exc)

        thread = threading.Thread(target=write, daemon=True,
                                  name="cloud-tpu-ckpt-write")
        self._write_thread = thread
        thread.start()

    def _gc_steps(self) -> None:
        """Keep the newest ``max_to_keep`` steps on disk."""
        if not self._max_to_keep:
            return
        for stale in self.steps()[:-self._max_to_keep]:
            shutil.rmtree(self._step_dir(stale), ignore_errors=True)

    def restore(self, step: Optional[int] = None, *, template: Any = None):
        """The state saved at ``step`` (the latest by default).

        With a ``template`` (a state of the same structure, e.g. the
        trainer's own), each leaf comes back with the template's shape,
        dtype and device (and ``requires_grad``), and any mismatch in
        structure, shape or dtype raises ``ValueError``.  Without one,
        the saved tree comes back with its tensors on the manager's
        device.  A step whose files are damaged raises too."""
        self._join_write(raise_error=False)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self._directory}")
        with tracing.span("checkpoint/restore", step=int(step)):
            faults.fault_point("checkpoint.restore")
            step_dir = self._step_dir(step)
            with open(os.path.join(step_dir, INDEX_NAME),
                      encoding="utf-8") as f:
                index = json.load(f)
            entries = index["leaves"]

            def leaf(i, like):
                if like is None:
                    return _read_leaf(step_dir, entries[i],
                                      pin=False).to(self._device)
                want = _leaf_tensor(like)
                value = _read_leaf(step_dir, entries[i],
                                   pin=want.device.type == "cuda")
                if (tuple(value.shape) != tuple(want.shape)
                        or value.dtype != want.dtype):
                    raise ValueError(
                        f"checkpoint leaf {entries[i]['key']!r} is "
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
        quarantine or an out-of-band delete is reflected)."""
        try:
            names = os.listdir(self._directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.isdir(
            os.path.join(self._directory, n)))

    def wait(self) -> None:
        """Wait for the write in flight, then commit every pending
        manifest: the durability barrier before a process may exit.
        Raises the error of a failed write."""
        try:
            self._join_write()
        finally:
            self._finalize_pending()

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
        if not extras or not _is_chief():
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
        (restorable, unverified) — never kills training.
        """
        if not _is_chief():
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
        manifest — a save whose commit a hard kill interrupted).
        """
        status = self._verify_on_disk(step)
        # Chaos seam: a corrupt-mode rule can force any verdict.
        return faults.fault_point("checkpoint.verify", status)

    def _verify_on_disk(self, step: int) -> str:
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
        job until it passed that step.
        """
        step_dir = self._step_dir(step)
        if not os.path.isdir(step_dir):
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


def _restore_matching_rng(manager: CheckpointManager, step: int, current):
    """Restore ``step`` into the current TrainState's structure.  The
    port's states carry no rng chain yet (stochastic steps wait for
    ROADMAP.md A.6): the template has none and the current one's, None,
    is carried forward."""
    template = current
    if isinstance(current, TrainState):
        template = dataclasses.replace(current, rng=None)
    restored = manager.restore(step, template=template)
    if isinstance(restored, TrainState):
        restored = dataclasses.replace(restored, rng=current.rng)
    return restored


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
    restored values into its static buffers at its next call.

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
    try:
        candidates = [
            s for s in sorted(manager.steps(), reverse=True)
            if not (only_if_ahead and s <= current_step)
        ]
    except Exception:  # noqa: BLE001 — unreadable dir: fresh start
        logger.exception("could not list checkpoints in %r",
                         manager.directory)
        return False
    if not candidates:
        return False
    for step in candidates:
        try:
            status = manager.verify(step)
        except Exception:  # noqa: BLE001 — chaos or IO error in verify
            logger.exception("checkpoint verify raised at step %d; "
                             "skipping it", step)
            _note_fallback(step, "verify_error")
            if quarantine:
                manager.quarantine(step)
            continue
        if status == _CORRUPT:
            logger.error(
                "checkpoint step %d failed integrity verification; "
                "walking back", step,
            )
            _note_fallback(step, "corrupt")
            if quarantine:
                manager.quarantine(step)
            continue
        try:
            restored = _restore_matching_rng(manager, step, current)
        except Exception:  # noqa: BLE001 — walk back instead of dying
            logger.exception(
                "could not restore checkpoint step %d (%s); walking back",
                step, status,
            )
            _note_fallback(step, "restore_failed")
            if quarantine:
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

    ``device`` is the manager's (see :class:`CheckpointManager`).
    """

    def __init__(self, directory: str, *, every_n_steps: int = 100,
                 max_to_keep: int = 3, resume: bool = True,
                 resume_data: bool = False, device=None):
        self.directory = directory
        self.every_n_steps = every_n_steps
        self.max_to_keep = max_to_keep
        self.resume = resume
        self.resume_data = resume_data
        self.device = device
        self._manager: Optional[CheckpointManager] = None
        #: Last step observed by on_step_end — fused dispatch (k>1)
        #: reports only window-boundary steps, so the periodic trigger
        #: fires on interval CROSSINGS, not on exact multiples.
        self._prev_step: Optional[int] = None

    # Lazily create the manager so the callback object stays picklable
    # before/after training (managers hold threads).
    def _get(self) -> CheckpointManager:
        if self._manager is None:
            self._manager = CheckpointManager(
                self.directory, max_to_keep=self.max_to_keep,
                save_interval_steps=self.every_n_steps, device=self.device,
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
        if self.resume and trainer.state is not None:
            resume_trainer_state(trainer, self._get(),
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
                self._get().save(step, trainer.state,
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
            manager = self._get()
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
            manager = self._get()
            # force: the drain/final step is rarely a multiple of
            # every_n_steps, and the modulo interval policy would skip it.
            manager.save(int(state.step), state, extras=extras, force=True)
        except Exception:  # noqa: BLE001 — retried once, then strict
            logger.exception(
                "train-end checkpoint save failed; retrying once with a "
                "fresh manager"
            )
            self._reset_manager_after_failure()
            manager = self._get()
            manager.save(int(state.step), state, extras=extras, force=True)
        manager.wait()
        manager.close()
        self._manager = None

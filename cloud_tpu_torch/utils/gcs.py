"""``gs://`` paths through a storage client.

The client has ``google.cloud.storage.Client``'s surface, of which the
port calls only ``bucket(name)``, then ``blob(name)`` with
``upload_from_string(data)``, ``download_as_bytes()`` and ``delete()``,
and ``list_blobs(prefix=)`` whose items carry ``.name``.  Every ``gs://``
path of the port takes an injected ``storage_client``; ``google.cloud`` is
imported only when none is given, so a host without
``google-cloud-storage`` runs every ``gs://`` path on a fake.
"""

from __future__ import annotations

from typing import List, Tuple


def is_gcs(path: str) -> bool:
    return str(path).startswith("gs://")


def split(path: str) -> Tuple[str, str]:
    """``gs://bucket/name`` -> ``("bucket", "name")``."""
    bucket, _, name = str(path)[len("gs://"):].partition("/")
    return bucket, name


def join(*parts: str) -> str:
    """``parts`` joined by ``/`` (the first kept as given but its trailing
    slash)."""
    return "/".join(p.strip("/") if i else p.rstrip("/")
                    for i, p in enumerate(parts))


def client(storage_client=None):
    """``storage_client``, or a ``google.cloud.storage.Client()`` when it
    is None (imported here, not before)."""
    if storage_client is not None:
        return storage_client
    from google.cloud import storage

    return storage.Client()


def blob(path: str, storage_client=None):
    bucket, name = split(path)
    return client(storage_client).bucket(bucket).blob(name)


def write_bytes(path: str, data: bytes, storage_client=None) -> None:
    blob(path, storage_client).upload_from_string(bytes(data))


def read_bytes(path: str, storage_client=None) -> bytes:
    return blob(path, storage_client).download_as_bytes()


def delete(path: str, storage_client=None) -> None:
    blob(path, storage_client).delete()


def list_paths(prefix: str, storage_client=None) -> List[str]:
    """The ``gs://`` paths of every object whose name starts with the name
    part of ``prefix``, sorted."""
    bucket, name = split(prefix)
    listed = client(storage_client).bucket(bucket).list_blobs(prefix=name)
    return sorted(f"gs://{bucket}/{b.name}" for b in listed)

"""A storage client for ``gs://`` paths, backed by a local directory.

It has the part of ``google.cloud.storage.Client``'s surface that the port
and the JAX package call: ``bucket(name).blob(name)`` with
``upload_from_string``, ``download_as_bytes`` and ``delete``, and
``bucket(name).list_blobs(prefix=)``.  Bucket ``b``'s object ``x/y`` is
the file ``<root>/b/x/y``; an upload lands by an atomic rename, so several
processes given the same root share one bucket.  Every call is counted in
``calls`` (by method name).
"""

import collections
import os
import tempfile


class NotFound(Exception):
    """What ``google.api_core.exceptions.NotFound`` is to the real client."""


class _Blob:
    def __init__(self, client, bucket, name):
        self._client, self.bucket, self.name = client, bucket, name

    @property
    def _path(self):
        return os.path.join(self._client.root, self.bucket, self.name)

    def upload_from_string(self, data, content_type=None):
        self._client.calls["upload_from_string"] += 1
        path = self._path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=DirectoryStorage.UPLOAD_PREFIX)
        with os.fdopen(fd, "wb") as f:
            f.write(data.encode() if isinstance(data, str) else bytes(data))
        os.replace(tmp, path)

    def download_as_bytes(self):
        self._client.calls["download_as_bytes"] += 1
        try:
            with open(self._path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise NotFound(f"gs://{self.bucket}/{self.name}") from None

    def delete(self):
        self._client.calls["delete"] += 1
        try:
            os.remove(self._path)
        except FileNotFoundError:
            raise NotFound(f"gs://{self.bucket}/{self.name}") from None


class _Bucket:
    def __init__(self, client, name):
        self._client, self.name = client, name

    def blob(self, name):
        return _Blob(self._client, self.name, name)

    def list_blobs(self, prefix=""):
        self._client.calls["list_blobs"] += 1
        base = os.path.join(self._client.root, self.name)
        names = []
        for root, _, files in os.walk(base):
            for f in files:
                if f.startswith(DirectoryStorage.UPLOAD_PREFIX):
                    continue
                name = os.path.relpath(os.path.join(root, f), base)
                name = name.replace(os.sep, "/")
                if name.startswith(prefix or ""):
                    names.append(name)
        return [_Blob(self._client, self.name, n) for n in sorted(names)]


class DirectoryStorage:
    """The client: ``DirectoryStorage(root)`` (a fresh temporary directory
    when ``root`` is None)."""

    UPLOAD_PREFIX = ".upload-"

    def __init__(self, root=None):
        self.root = root or tempfile.mkdtemp(prefix="fake-gcs-")
        self.calls = collections.Counter()

    def bucket(self, name):
        return _Bucket(self, name)

    def objects(self, bucket):
        """Every object name of ``bucket``, sorted."""
        return [b.name for b in self.bucket(bucket).list_blobs()]

"""External spill storage — pluggable backends behind one URI interface.

Analog of the reference's `python/ray/_private/external_storage.py:496`
(`ExternalStorage` + filesystem/S3 implementations behind
`object_spilling_config`): the node object store spills cold objects
through whichever backend the spill URI selects, so spill capacity can
live on a local disk, a remote object store, or (in tests) a fake remote.

Backends by scheme:
  - ``""`` / ``file://``  — local filesystem directory (default)
  - ``mock://``           — fake remote store for tests: same URI contract
                            as a real remote (opaque returned URIs, no
                            local-path semantics), backed by a directory
                            plus op counters
  - ``s3://``             — S3-class object storage via boto3 when
                            available (gated: this image has no boto3, so
                            constructing it raises with a clear message)
"""

from __future__ import annotations

import os
import uuid
from typing import Dict


class ExternalStorage:
    """One spilled object = one (key, payload) in the backend. `put`
    returns an opaque URI that `get`/`delete` accept — callers must not
    parse it (a remote backend's URIs carry no local meaning). `data` is
    bytes-like (often a memoryview into the arena — backends that need
    real bytes copy themselves)."""

    def put(self, key: str, data) -> str:
        raise NotImplementedError

    def get(self, uri: str) -> bytes:
        raise NotImplementedError

    def list_keys(self, prefix: str):
        """(key, uri) pairs for stored objects whose key starts with
        *prefix* — the discovery primitive control-plane recovery needs
        (every real object store has a list op). Latest write per key
        wins when a backend versions its objects."""
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """Spill to a local directory (the default backend)."""

    def __init__(self, base_dir: str):
        self._dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def put(self, key: str, data: bytes) -> str:
        path = os.path.join(self._dir, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # readers never see a half-written spill
        return "file://" + path

    def get(self, uri: str) -> bytes:
        with open(uri[len("file://"):], "rb") as f:
            return f.read()

    def list_keys(self, prefix: str):
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return [(n, "file://" + os.path.join(self._dir, n))
                for n in names
                if n.startswith(prefix) and not n.endswith(".tmp")]

    def delete(self, uri: str) -> None:
        try:
            os.unlink(uri[len("file://"):])
        except OSError:
            pass


class MockRemoteStorage(ExternalStorage):
    """Fake remote object store for tests: honors the exact URI contract
    of a real remote (opaque URIs with a random token, so any caller
    that treats them as paths breaks loudly) and counts operations."""

    def __init__(self, base_dir: str):
        self._dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.puts = 0
        self.gets = 0
        self.deletes = 0

    def _path(self, uri: str) -> str:
        assert uri.startswith("mock://"), uri
        return os.path.join(self._dir, uri[len("mock://"):])

    def put(self, key: str, data: bytes) -> str:
        self.puts += 1
        token = f"{key}-{uuid.uuid4().hex[:8]}"
        with open(os.path.join(self._dir, token), "wb") as f:
            f.write(data)
        uri = "mock://" + token
        # durable key index (a real remote serves list from its own
        # metadata; the fake needs one so a NEW process can discover
        # keys after the writer died — the control-plane recovery path)
        with open(os.path.join(self._dir, "_index"), "a") as f:
            f.write(f"{key}\t{uri}\n")
        return uri

    def get(self, uri: str) -> bytes:
        self.gets += 1
        with open(self._path(uri), "rb") as f:
            return f.read()

    def list_keys(self, prefix: str):
        out = {}
        try:
            with open(os.path.join(self._dir, "_index")) as f:
                for line in f:
                    key, _, uri = line.rstrip("\n").partition("\t")
                    if key.startswith(prefix) and uri:
                        out[key] = uri  # latest write per key wins
        except OSError:
            return []
        # drop entries whose object was deleted
        return [(k, u) for k, u in out.items()
                if os.path.exists(self._path(u))]

    def delete(self, uri: str) -> None:
        self.deletes += 1
        try:
            os.unlink(self._path(uri))
        except OSError:
            pass


class S3Storage(ExternalStorage):
    """S3-class backend (``s3://bucket/prefix``). Requires boto3, which
    this image does not ship — the class exists so a deployment with
    boto3 gets the full path, and everyone else a clear error."""

    def __init__(self, uri: str):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "s3:// spill requires boto3, which is not installed; "
                "use a file:// or local-directory spill target") from e
        rest = uri[len("s3://"):]
        self._bucket, _, self._prefix = rest.partition("/")
        import boto3

        self._client = boto3.client("s3")

    def _key(self, uri: str) -> str:
        return uri[len("s3://") + len(self._bucket) + 1:]

    def put(self, key: str, data: bytes) -> str:
        full = (self._prefix + "/" + key).lstrip("/")
        self._client.put_object(Bucket=self._bucket, Key=full, Body=data)
        return f"s3://{self._bucket}/{full}"

    def get(self, uri: str) -> bytes:
        out = self._client.get_object(Bucket=self._bucket,
                                      Key=self._key(uri))
        return out["Body"].read()

    def list_keys(self, prefix: str):
        full = (self._prefix + "/" + prefix).lstrip("/")
        out = []
        token = None
        while True:
            kw = {"Bucket": self._bucket, "Prefix": full}
            if token:
                kw["ContinuationToken"] = token
            resp = self._client.list_objects_v2(**kw)
            for obj in resp.get("Contents", []):
                key = obj["Key"]
                short = key[len(self._prefix) + 1:] if self._prefix else key
                out.append((short, f"s3://{self._bucket}/{key}"))
            if not resp.get("IsTruncated"):
                return out
            token = resp.get("NextContinuationToken")

    def delete(self, uri: str) -> None:
        try:
            self._client.delete_object(Bucket=self._bucket,
                                       Key=self._key(uri))
        except Exception:
            pass


def storage_from_spill_target(target: str, default_dir: str
                              ) -> ExternalStorage:
    """Build the backend for a spill target (config.object_spilling_uri):
    empty -> local default dir; file:///path or /path -> that dir;
    mock://dir -> fake remote; s3://... -> S3."""
    if not target:
        return FileSystemStorage(default_dir)
    if target.startswith("file://"):
        return FileSystemStorage(target[len("file://"):])
    if target.startswith("mock://"):
        return MockRemoteStorage(target[len("mock://"):])
    if target.startswith("s3://"):
        return S3Storage(target)
    if "://" not in target:
        return FileSystemStorage(target)
    raise ValueError(f"unsupported spill target {target!r}")

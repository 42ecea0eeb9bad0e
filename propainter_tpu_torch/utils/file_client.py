"""Storage backends for dataset IO.

Equivalent of reference utils/file_client.py:131 (FileClient with disk /
lmdb / memcached backends, of which the datasets use disk and lmdb). The
disk backend is the default; lmdb is available when the `lmdb` package is
installed (it is not in the TPU image — the backend raises a clear error
then). The memcached backend is a dependency-free text-protocol client
(the reference wraps the internal `mc` package,
utils/file_client.py:27-75) used as a read-through cache over disk.
"""

from __future__ import annotations

import hashlib
import socket


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(filepath, "r") as f:
            return f.read()


class LmdbBackend:
    """Read values from one or more LMDB databases (reference
    utils/file_client.py:34-90 semantics: client_keys map to db_paths;
    `get(key, client_key)` looks up the raw bytes)."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "the lmdb backend needs the 'lmdb' package (not bundled in "
                "the TPU image); use the disk backend or install lmdb"
            ) from e
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        assert len(client_keys) == len(db_paths)
        self._client = {
            k: lmdb.open(p, readonly=readonly, lock=lock,
                         readahead=readahead, **kwargs)
            for k, p in zip(client_keys, db_paths)
        }

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        client = self._client[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend:
    """Read-through cache over disk via the memcached TEXT protocol —
    no client package needed (the reference depends on the internal `mc`
    wheel, utils/file_client.py:27-75; this speaks get/set directly).

    Keys are sha1(filepath) (memcached keys are limited to 250 bytes, no
    spaces). A miss falls back to disk and populates the cache; server
    errors degrade to plain disk reads rather than failing the loader.
    """

    def __init__(self, server: str = "127.0.0.1:11211",
                 timeout: float = 1.0, max_value_bytes: int = 2 ** 20):
        host, _, port = server.partition(":")
        self._addr = (host, int(port or 11211))
        self._timeout = timeout
        self._max_value = max_value_bytes
        self._sock = None

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                self._addr, timeout=self._timeout)
        return self._sock

    def _close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    @staticmethod
    def _key(filepath: str) -> str:
        return hashlib.sha1(str(filepath).encode()).hexdigest()

    def _recv_until(self, sock, marker: bytes) -> bytes:
        buf = b""
        while marker not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed the connection")
            buf += chunk
        return buf

    def _mc_get(self, key: str) -> bytes | None:
        sock = self._connect()
        sock.sendall(f"get {key}\r\n".encode())
        buf = self._recv_until(sock, b"END\r\n")
        if not buf.startswith(b"VALUE "):
            return None  # miss
        header, rest = buf.split(b"\r\n", 1)
        nbytes = int(header.split()[3])
        while len(rest) < nbytes + len(b"\r\nEND\r\n"):
            rest += self._recv_until(sock, b"END\r\n")
        return rest[:nbytes]

    def _mc_set(self, key: str, data: bytes):
        if len(data) > self._max_value:
            return  # memcached default value cap is 1 MB
        sock = self._connect()
        sock.sendall(f"set {key} 0 0 {len(data)}\r\n".encode()
                     + data + b"\r\n")
        self._recv_until(sock, b"\r\n")

    def get(self, filepath: str) -> bytes:
        key = self._key(filepath)
        try:
            cached = self._mc_get(key)
            if cached is not None:
                return cached
        except OSError:
            self._close()
            return DiskBackend().get(filepath)
        data = DiskBackend().get(filepath)
        try:
            self._mc_set(key, data)
        except OSError:
            self._close()
        return data


class FileClient:
    """Facade dispatching to a storage backend (reference
    utils/file_client.py:131-183)."""

    _backends = {"disk": DiskBackend, "lmdb": LmdbBackend,
                 "memcached": MemcachedBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"backend {backend!r} not supported; choose from "
                f"{sorted(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend == "lmdb":
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)

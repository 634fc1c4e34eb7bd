"""Stats storage: keyed persistable blobs and listener notification: the
port of ``deeplearning4j_tpu/ui/storage.py`` (``api/storage/StatsStorage.java``,
``StatsStorageRouter``, ``Persistable``; ``InMemoryStatsStorage.java``,
``FileStatsStorage.java``, ``J7FileStatsStorage.java``).

Records are keyed (sessionID, typeID, workerID, timestamp); static infos
are keyed without the timestamp; listeners attached to a storage are told
of every put (the UI server subscribes this way). ``FileStatsStorage`` is
an append-only log of codec-framed records (a truncated tail is skipped),
``SqliteStatsStorage`` a database. Both formats are the reference's: a log
or a database that either package writes reads back in the other.
"""

from __future__ import annotations

import os
import struct
import threading

from deeplearning4j_tpu_torch.ui import codec


class Persistable:
    """One stats blob: (session_id, type_id, worker_id, timestamp) + content."""

    def __init__(self, session_id, type_id, worker_id, timestamp, content):
        self.session_id = session_id
        self.type_id = type_id
        self.worker_id = worker_id
        self.timestamp = timestamp
        self.content = content

    def encode(self) -> bytes:
        return codec.encode({
            "sessionID": self.session_id, "typeID": self.type_id,
            "workerID": self.worker_id, "timestamp": self.timestamp,
            "content": self.content})

    @staticmethod
    def decode(data: bytes) -> "Persistable":
        obj = codec.decode(data)
        return Persistable(obj["sessionID"], obj["typeID"], obj["workerID"],
                           obj["timestamp"], obj["content"])


class StatsStorageRouter:
    """Where listeners send reports (StatsStorageRouter.java)."""

    def put_static_info(self, persistable: Persistable):
        raise NotImplementedError

    def put_update(self, persistable: Persistable):
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Readable storage + listener registration (StatsStorage.java)."""

    def __init__(self):
        self._listeners = []
        self._lock = threading.RLock()

    def register_stats_storage_listener(self, fn):
        """fn(event_type, persistable); event_type in {'static', 'update'}."""
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, event_type, p):
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(event_type, p)

    # --- query API (StatsStorage.java read methods) ---
    def list_session_ids(self):
        raise NotImplementedError

    def list_type_ids(self, session_id):
        raise NotImplementedError

    def list_worker_ids(self, session_id, type_id):
        raise NotImplementedError

    def get_static_info(self, session_id, type_id, worker_id):
        raise NotImplementedError

    def get_all_updates_after(self, session_id, type_id, worker_id, timestamp):
        raise NotImplementedError

    def get_latest_update(self, session_id, type_id, worker_id):
        updates = self.get_all_updates_after(session_id, type_id, worker_id, -1)
        return updates[-1] if updates else None


class InMemoryStatsStorage(StatsStorage):
    """Dict-backed storage (InMemoryStatsStorage.java)."""

    def __init__(self):
        super().__init__()
        self._static = {}   # (s,t,w) -> Persistable
        self._updates = {}  # (s,t,w) -> [Persistable] sorted by ts

    def put_static_info(self, p):
        with self._lock:
            self._static[(p.session_id, p.type_id, p.worker_id)] = p
        self._notify("static", p)

    def put_update(self, p):
        with self._lock:
            self._updates.setdefault(
                (p.session_id, p.type_id, p.worker_id), []).append(p)
        self._notify("update", p)

    def list_session_ids(self):
        with self._lock:
            keys = set(k[0] for k in self._static) | set(k[0] for k in self._updates)
        return sorted(keys)

    def list_type_ids(self, session_id):
        with self._lock:
            keys = (set(k[1] for k in self._static if k[0] == session_id)
                    | set(k[1] for k in self._updates if k[0] == session_id))
        return sorted(keys)

    def list_worker_ids(self, session_id, type_id):
        with self._lock:
            keys = (set(k[2] for k in self._static if k[:2] == (session_id, type_id))
                    | set(k[2] for k in self._updates if k[:2] == (session_id, type_id)))
        return sorted(keys)

    def get_static_info(self, session_id, type_id, worker_id):
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))

    def get_all_updates_after(self, session_id, type_id, worker_id, timestamp):
        with self._lock:
            ups = list(self._updates.get((session_id, type_id, worker_id), []))
        return [p for p in ups if p.timestamp > timestamp]


_FRAME = struct.Struct("<BI")  # record kind (0=static, 1=update), payload length


class FileStatsStorage(InMemoryStatsStorage):
    """Append-only single-file storage (FileStatsStorage.java role, minus MapDB).

    All reads are served from the in-memory index; the file is the durable log,
    replayed on open. Truncated tail records (crash mid-append) are skipped.
    """

    def __init__(self, path):
        super().__init__()
        self.path = path
        self._fh = None
        if os.path.exists(path):
            self._replay()
        self._fh = open(path, "ab")

    def _replay(self):
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + _FRAME.size <= len(data):
            kind, length = _FRAME.unpack_from(data, pos)
            if pos + _FRAME.size + length > len(data):
                break  # truncated tail
            payload = data[pos + _FRAME.size:pos + _FRAME.size + length]
            pos += _FRAME.size + length
            try:
                p = Persistable.decode(payload)
            except ValueError:
                break
            if kind == 0:
                InMemoryStatsStorage.put_static_info(self, p)
            else:
                InMemoryStatsStorage.put_update(self, p)

    def _append(self, kind, p):
        payload = p.encode()
        with self._lock:
            self._fh.write(_FRAME.pack(kind, len(payload)))
            self._fh.write(payload)
            self._fh.flush()

    def put_static_info(self, p):
        self._append(0, p)
        super().put_static_info(p)

    def put_update(self, p):
        self._append(1, p)
        super().put_update(p)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class CollectionStatsStorageRouter(StatsStorageRouter):
    """Collect into lists (CollectionStatsStorageRouter.java — used in tests
    and by Spark workers to batch reports)."""

    def __init__(self):
        self.static_info = []
        self.updates = []

    def put_static_info(self, p):
        self.static_info.append(p)

    def put_update(self, p):
        self.updates.append(p)


class SqliteStatsStorage(StatsStorage):
    """SQLite-backed storage (``ui/storage/sqlite/J7FileStatsStorage.java``
    role). Unlike ``FileStatsStorage`` (durable log + in-memory index),
    every read is served from the database, so a reopened storage sees all
    prior sessions without a replay pass and multiple processes can read
    the same file.
    """

    def __init__(self, path):
        super().__init__()
        import sqlite3
        self.path = path
        self._db = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            # WAL + NORMAL: per-iteration put_update must not fsync the
            # training loop to a halt (synchronous=FULL is one fsync per
            # COMMIT); WAL keeps concurrent readers working
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.executescript("""
                CREATE TABLE IF NOT EXISTS static_info(
                    session_id TEXT, type_id TEXT, worker_id TEXT,
                    timestamp INTEGER, content BLOB,
                    PRIMARY KEY (session_id, type_id, worker_id));
                CREATE TABLE IF NOT EXISTS updates(
                    session_id TEXT, type_id TEXT, worker_id TEXT,
                    timestamp INTEGER, content BLOB);
                CREATE INDEX IF NOT EXISTS idx_updates
                    ON updates(session_id, type_id, worker_id, timestamp);
            """)
            self._db.commit()

    def put_static_info(self, p):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?,?,?,?,?)",
                (p.session_id, p.type_id, p.worker_id, p.timestamp,
                 p.encode()))
            self._db.commit()
        self._notify("static", p)

    def put_update(self, p):
        with self._lock:
            self._db.execute(
                "INSERT INTO updates VALUES (?,?,?,?,?)",
                (p.session_id, p.type_id, p.worker_id, p.timestamp,
                 p.encode()))
            self._db.commit()
        self._notify("update", p)

    def _column(self, sql, args=()):
        with self._lock:
            rows = self._db.execute(sql, args).fetchall()
        return sorted(r[0] for r in rows)   # UNION already deduplicates

    def list_session_ids(self):
        return self._column(
            "SELECT session_id FROM static_info "
            "UNION SELECT session_id FROM updates")

    def list_type_ids(self, session_id):
        return self._column(
            "SELECT type_id FROM static_info WHERE session_id=? "
            "UNION SELECT type_id FROM updates WHERE session_id=?",
            (session_id, session_id))

    def list_worker_ids(self, session_id, type_id):
        return self._column(
            "SELECT worker_id FROM static_info WHERE session_id=? AND type_id=? "
            "UNION SELECT worker_id FROM updates WHERE session_id=? AND type_id=?",
            (session_id, type_id, session_id, type_id))

    def get_static_info(self, session_id, type_id, worker_id):
        with self._lock:
            row = self._db.execute(
                "SELECT content FROM static_info WHERE session_id=? AND "
                "type_id=? AND worker_id=?",
                (session_id, type_id, worker_id)).fetchone()
        return Persistable.decode(row[0]) if row else None

    def get_all_updates_after(self, session_id, type_id, worker_id, timestamp):
        with self._lock:
            rows = self._db.execute(
                "SELECT content FROM updates WHERE session_id=? AND type_id=? "
                "AND worker_id=? AND timestamp>? ORDER BY timestamp",
                (session_id, type_id, worker_id, timestamp)).fetchall()
        return [Persistable.decode(r[0]) for r in rows]

    def get_latest_update(self, session_id, type_id, worker_id):
        with self._lock:
            row = self._db.execute(
                "SELECT content FROM updates WHERE session_id=? AND type_id=? "
                "AND worker_id=? ORDER BY timestamp DESC LIMIT 1",
                (session_id, type_id, worker_id)).fetchone()
        return Persistable.decode(row[0]) if row else None

    def close(self):
        with self._lock:
            self._db.close()

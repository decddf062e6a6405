"""Abstract-SQL filer store: one SQL implementation, many engines.

The port's reduced copy of seaweedfs_tpu/filer/abstract_sql.py
(upstream weed/filer/abstract_sql/abstract_sql_store.go): all CRUD and
listing SQL lives here, parameterized by a ``Dialect`` (placeholder
style, upsert form, the LIKE escape), and an engine contributes only a
connection. Engines: sqlite (stdlib ``sqlite3``), the CLI filer's
default store, whose tables, rows and listing order are the reference's,
so either package opens the other's database; mysql and postgres, which
bind to their DB-API drivers (``pymysql``, ``psycopg2``) when installed
and raise a ``RuntimeError`` naming the missing module when not. Their dialects'
SQL is the reference's, statement for statement.
"""

from __future__ import annotations

import threading
from typing import Optional

from .entry import Entry
from .stores import FilerStore, _split


class Dialect:
    """SQL variation points (abstract_sql_store.go's GenSql* hooks)."""

    placeholder = "?"
    like_escape = r"ESCAPE '\'"

    def upsert_entry(self) -> str:
        return ("INSERT OR REPLACE INTO entries (dir, name, meta) "
                f"VALUES ({self.placeholder},{self.placeholder},"
                f"{self.placeholder})")

    def upsert_kv(self) -> str:
        return ("INSERT OR REPLACE INTO kv (k, v) "
                f"VALUES ({self.placeholder},{self.placeholder})")

    def create_tables(self) -> list[str]:
        return [
            """CREATE TABLE IF NOT EXISTS entries (
                   dir TEXT NOT NULL,
                   name TEXT NOT NULL,
                   meta TEXT NOT NULL,
                   PRIMARY KEY (dir, name)
               )""",
            """CREATE TABLE IF NOT EXISTS kv (
                   k TEXT PRIMARY KEY,
                   v BLOB NOT NULL
               )""",
        ]


class MysqlDialect(Dialect):
    placeholder = "%s"
    # MySQL reads a backslash in a string literal as an escape: its
    # ESCAPE clause doubles it
    like_escape = r"ESCAPE '\\'"

    def upsert_entry(self) -> str:
        return ("INSERT INTO entries (dir, name, meta) VALUES (%s,%s,%s) "
                "ON DUPLICATE KEY UPDATE meta=VALUES(meta)")

    def upsert_kv(self) -> str:
        return ("INSERT INTO kv (k, v) VALUES (%s,%s) "
                "ON DUPLICATE KEY UPDATE v=VALUES(v)")


class PostgresDialect(Dialect):
    placeholder = "%s"

    def upsert_entry(self) -> str:
        return ("INSERT INTO entries (dir, name, meta) VALUES (%s,%s,%s) "
                "ON CONFLICT (dir, name) DO UPDATE SET meta=EXCLUDED.meta")

    def upsert_kv(self) -> str:
        return ("INSERT INTO kv (k, v) VALUES (%s,%s) "
                "ON CONFLICT (k) DO UPDATE SET v=EXCLUDED.v")


class AbstractSqlStore(FilerStore):
    """All filer-store SQL, engine-independent. One connection per
    thread; inside a transaction (``begin``) writes wait for ``commit``."""

    name = "abstract_sql"
    dialect = Dialect()

    def _connect(self):
        raise NotImplementedError

    def __init__(self):
        self._local = threading.local()
        self._init_schema()

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._connect()
            self._local.conn = conn
        return conn

    def _in_txn(self) -> bool:
        return getattr(self._local, "in_txn", False)

    def _commit(self, conn) -> None:
        if not self._in_txn():
            conn.commit()

    def begin(self) -> None:
        self._local.in_txn = True

    def commit(self) -> None:
        self._local.in_txn = False
        self._conn().commit()

    def rollback(self) -> None:
        self._local.in_txn = False
        self._conn().rollback()

    def _init_schema(self) -> None:
        conn = self._conn()
        cur = conn.cursor()
        for stmt in self.dialect.create_tables():
            cur.execute(stmt)
        conn.commit()

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        conn = self._conn()
        conn.cursor().execute(self.dialect.upsert_entry(),
                              (d, name, entry.to_json()))
        self._commit(conn)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Optional[Entry]:
        d, name = _split(path)
        if name == "/":
            return None
        ph = self.dialect.placeholder
        cur = self._conn().cursor()
        cur.execute(f"SELECT meta FROM entries WHERE dir={ph} AND name={ph}",
                    (d, name))
        row = cur.fetchone()
        return Entry.from_json(row[0]) if row else None

    def delete_entry(self, path: str) -> None:
        d, name = _split(path)
        ph = self.dialect.placeholder
        conn = self._conn()
        conn.cursor().execute(
            f"DELETE FROM entries WHERE dir={ph} AND name={ph}", (d, name))
        self._commit(conn)

    def delete_folder_children(self, path: str) -> None:
        path = path.rstrip("/") or "/"
        ph = self.dialect.placeholder
        conn = self._conn()
        cur = conn.cursor()
        if path == "/":
            cur.execute("DELETE FROM entries WHERE dir != ''")
        else:
            cur.execute(
                f"DELETE FROM entries WHERE dir = {ph} OR dir LIKE {ph}",
                (path, path + "/%"))
        self._commit(conn)

    def list_directory_entries(self, dir_path: str, start_file_name: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        ph = self.dialect.placeholder
        op = ">=" if include_start else ">"
        sql = f"SELECT meta FROM entries WHERE dir={ph} AND name {op} {ph}"
        args: list = [dir_path, start_file_name]
        if prefix:
            sql += f" AND name LIKE {ph} {self.dialect.like_escape}"
            escaped = (prefix.replace("\\", r"\\")
                       .replace("%", r"\%").replace("_", r"\_"))
            args.append(escaped + "%")
        sql += f" ORDER BY name LIMIT {ph}"
        args.append(limit)
        cur = self._conn().cursor()
        cur.execute(sql, args)
        return [Entry.from_json(r[0]) for r in cur.fetchall()]

    def kv_put(self, key: str, value: bytes) -> None:
        conn = self._conn()
        conn.cursor().execute(self.dialect.upsert_kv(), (key, value))
        conn.commit()

    def kv_get(self, key: str) -> Optional[bytes]:
        ph = self.dialect.placeholder
        cur = self._conn().cursor()
        cur.execute(f"SELECT v FROM kv WHERE k={ph}", (key,))
        row = cur.fetchone()
        return bytes(row[0]) if row else None

    def iter_directories(self):
        cur = self._conn().cursor()
        cur.execute("SELECT DISTINCT dir FROM entries "
                    "WHERE dir != '' ORDER BY dir")
        return iter([r[0] for r in cur.fetchall()])

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


class SqliteStore(AbstractSqlStore):
    """The embedded sqlite engine: the CLI filer's default store."""

    name = "sqlite"
    dialect = Dialect()

    def __init__(self, path: str = "filer.db", **_):
        self._path = path
        super().__init__()

    def _connect(self):
        import sqlite3
        conn = sqlite3.connect(self._path, timeout=30)
        conn.execute("PRAGMA journal_mode=WAL")
        return conn


def _db_module(module: str, store: str):
    """The DB-API driver `module`; a RuntimeError naming it if it is not
    installed."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"filer store {store!r} needs the {module} "
                           "driver, which is not installed") from e


class MysqlStore(AbstractSqlStore):
    """The mysql engine (filer store ``mysql``)."""

    name = "mysql"
    dialect = MysqlDialect()

    def __init__(self, host: str = "localhost", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "seaweedfs", **_):
        self._params = dict(host=host, port=port, user=user,
                            password=password, database=database)
        super().__init__()

    def _connect(self):
        return _db_module("pymysql", self.name).connect(**self._params)


class PostgresStore(AbstractSqlStore):
    """The postgres engine (filer store ``postgres``)."""

    name = "postgres"
    dialect = PostgresDialect()

    def __init__(self, host: str = "localhost", port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "seaweedfs", **_):
        self._params = dict(host=host, port=port, user=user,
                            password=password, dbname=database)
        super().__init__()

    def _connect(self):
        return _db_module("psycopg2", self.name).connect(**self._params)

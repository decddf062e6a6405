"""The filer: a POSIX-style namespace of files over the blob store.

The port's reduced copy of seaweedfs_tpu/filer/: chunk math
(``chunks``), entries (``entry``), the store contract and its embedded
stores (``stores``: memory; ``abstract_sql``: sqlite; ``leveldb_store``,
``leveldb2_store``), the namespace core with its event log (``filer``),
chunk manifests (``manifest``), the bulk-assign lease pool
(``assign_lease``) and the bounded upload window (``upload_window``).
The HTTP face is server/filer_server.py.

Left out: the network stores and their fakes (redis, redis2, etcd,
mongodb, elastic, cassandra, mysql, postgres) and the ``KvSequencer``.
"""

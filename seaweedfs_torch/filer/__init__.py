"""The filer: a POSIX-style namespace of files over the blob store.

The port's reduced copy of seaweedfs_tpu/filer/: chunk math
(``chunks``), entries (``entry``), the store contract and its stores
(``stores``: memory; ``abstract_sql``: sqlite, mysql, postgres;
``leveldb_store``, ``leveldb2_store``; the network stores
``redis_store``, ``redis2_store``, ``etcd_store``, ``mongodb_store``,
``elastic_store``, ``cassandra_store``, each with its fake server
``fake_*`` and the wire helpers ``netutil`` and ``bson_lite``), the
namespace core with its event log (``filer``), chunk manifests
(``manifest``), the bulk-assign lease pool (``assign_lease``) and the
bounded upload window (``upload_window``). The HTTP face is
server/filer_server.py.
"""

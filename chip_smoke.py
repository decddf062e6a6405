#!/usr/bin/env python3
"""Smoke run of the seaweedfs_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name, count and power limit, and the kernels' build (one
   nvcc per source, all at once, from the sources in this checkout);
2. each hand-written GF(2^8) kernel against its plain PyTorch version on
   the card: RS(10,4), RS(20,4) and RS(6,3); widths 1, 1023, 64 KiB + 3,
   1 MiB + 5, 8 MiB and 16 MiB; the parity matrix, a zero-padded
   reconstruction matrix for victims {0, 3, 7, 12} (rebuild) and the
   unpadded one-row matrix for victim 0 (a degraded read); bit equality
   required, 54 cases per kernel: (2) ``gf_apply`` (bit-plane matrix
   operand), (2b) ``gf_apply_xorsched`` (the matrix's grouped XOR
   program) and (2c) ``gf_apply_mxu`` (the same operand, both products on
   the tensor cores, on wgmma and again on mma.sync), which must also
   equal ``gf_apply`` on the same inputs; the first two also with their
   digest epilogue, with and without output stores, whose [C + R] sums
   must equal the plain ones;
3. the main path at full size under the default ``bitplane``
   formulation: a 512 MiB volume (1 GiB before phase 19; seeded
   needles, log-uniform 1 KiB .. 4 MiB, about 5% deleted) written with
   the port's Volume,
   ``stream_encode`` with ``get_coder("auto", 10, 4)`` under the default
   RS(10,4) geometry (1 GiB large / 1 MiB small blocks), the sorted .ecx,
   the parity held against the plain version over the whole volume, every
   live needle read through ``EcVolume``, the same with shards
   {0, 3, 7, 12} deleted (degraded reads through the kernel),
   ``stream_rebuild`` (sha256 of the rebuilt shards), ``write_dat_file``
   (the decoded .dat equals the source), and (3c) the device sinks
   ``stream_encode_device_sink`` and ``stream_rebuild_device_sink`` of the
   four victims, whose digests must equal the shard files' and the .ecm's
   stamped ones. The encode's .ecm digests come from the kernels' digest
   epilogue (the host sum is never called: counted) and must equal the
   shard files'; the sinks call no ``torch.sum`` (counted). All three
   kernels' launch counts are set to 0 before
   each step and read after it; only the formulation's kernel may run
   (the tensor-core kernel never does, as in the reference);
   (3b) the same with ``TorchCoder(10, 4, formulation="xorsched")`` on a
   copy of the same volume (written once from the seed: needle records
   carry their append time, so two writes differ): its 14 shard files
   must equal the bitplane run's by sha256, and only the XOR-schedule
   kernel may run;
   ``get_coder("auto")`` under ``WEED_EC_FORMULATION=xorsched`` must give
   the xorsched coder;
   (3d) the governed pipeline on a copy of the same volume, with the
   governor, the span ring and the wide events reset first: three
   ``stream_encode(base, coder)`` runs with no batch size or depth (one
   line each: the planned operating point, the ``ec.*`` span totals,
   GB/s, the staging pool's allocation time, the feed), a fourth under
   ``torch.profiler`` (the device's kernel, copy and busy seconds and its
   idle share over the run); then on each feed, mmap, ``WEED_EC_MMAP=0``
   and ``WEED_EC_ODIRECT=1`` (whether O_DIRECT engaged), one
   ``stream_encode_many`` over two copies and one governed
   ``stream_rebuild`` of the four victims, and a governed encode on the
   last two; all with shards equal by sha256 to the pinned run's; a fault drill on the preadv feed
   (``ec.feed.read`` armed as an error: ``FaultError`` and no .ecm; after
   ``faults.clear()`` the next run succeeds); the tensor-core kernel's
   entry, ``rs_cuda.gf_apply(w, x, repack="mxu")``, applied to every
   [10, 8 MiB] batch of the data shards, equal to the parity shards; the
   "ec" metrics registry on one line;
4. the same as 3/3b at a mixed-tier layout (262144 / 16384 blocks, 4 MiB
   volume), under both formulations;
6. (run before 5) ``Store(coder_name="auto")`` under the default policy
   (no ``WEED_EC_GEOMETRY``: ``default=10+4,archive=20+4``) and the
   default formulation. (6a) the default collection, RS(10,4): a 1 GiB
   volume written with ``Store.write_needle`` (phase 3's generator,
   about 5% deleted), ``ec_generate`` (parity held against the plain
   version over the whole volume, .ecm digests from the kernels' epilogue
   equal to the shard files'), ``close`` and a new Store that finds the
   EC volume with 14 shards, every needle read, ``ec_delete_shards`` of
   {0, 3, 7, 12} and every needle read again (degraded), ``ec_blob_delete``
   of 8 needles (refused after, journaled in .ecj), ``ec_rebuild``
   (rebuilt shards' sha256 equal, .ecj folded into .ecx),
   ``ec_to_volume`` (the decoded .dat equals the source up to its last
   live needle; every needle reads from the restored volume). (6b) the
   ``archive`` collection, RS(20,4): a 128 MiB volume (1 GiB before
   phase 11, 512 MiB before phase 13, 256 MiB before phase 14) of the
   fused
   warm-down tests' five payload kinds, 30% tombstoned (upstream's default
   vacuum garbageThreshold), ``ec_fused_generate`` (24 shards, a marker
   naming RS(20,4), the decoded .dat equal to the sequential
   per-needle-read-and-gzip chain's, parity equal to the plain version's,
   .ecm digests equal to the files', no staging file left, every 8th
   needle (a fixed sample: the first and each 8th after it) read back
   decompressed through an ``EcVolume`` with 4 shards lost, or refused
   when deleted), with one line of the pass's wall time, GB/s of the source
   volume, stats and ``ec.*`` span totals. Every step's launches are
   counted: only ``gf_apply`` may run, and it must in the coder's steps;
7. (run after 6) the same path through the port's servers, the EC shell
   and the CLI, under the default policy: (7a) a master and 3 volume
   servers in this process (``LocalCluster``, each server its own
   directory and ``Store(coder_name="auto")``, master volume size limit
   1024 MB), on loopback ports; one volume of collection ``ecsmoke`` grown
   and filled to 256 MiB (1 GiB before phase 12, 512 MiB before phase
   14) over HTTP through the
   port's ``Client`` (phase 3's generator, about 5% deleted with HTTP
   DELETE), its sealed .dat copied,
   the shell's ``EcCommands.encode`` (14 shards spread 5/5/4, the volume
   retired; the shard files gathered from the three directories: parity
   equal to the plain version's, data shards decoding to the sealed
   copy), every needle read over HTTP, again with one data shard of the
   4-shard server deleted, again with that server stopped and pruned (4
   shards lost; survivors fetched from the peer over
   ``/admin/ec/shard_read``), ``EcCommands.rebuild`` (sha256 of the
   rebuilt shards equal), ``EcCommands.decode`` and reads of the decoded
   volume; every step's launches counted: ``gf_apply`` must run in the
   encode, both degraded reads and the rebuild, and nothing else
   anywhere; (7b) ``python3 -m seaweedfs_torch.cli`` master and ``volume
   -coder auto`` as processes, 48 uploads into a 64 MB-limit volume,
   ``shell ec.encode``, one shard deleted, every needle read back, the
   processes stopped at the end. The servers are aiohttp applications on
   one event loop, on one rack. The master runs with
   ``repair_enabled=False`` (the CLI's with ``-maintenance_interval 0``):
   the shell heals phases 7 and 8, and the repair daemon would race it;
8. (run inside 7a's cluster, before 7b) the hot tier in front of the
   warm one: a fresh server takes the place of the one 7a lost; a 128 MiB
   volume (1 GiB before phase 12, 512 MiB before phase 14, 256 MiB before
   phase 18) of collection
   ``repsmoke`` at replication ``001`` (upstream's
   "one more copy on the same rack") filled over HTTP with phase 3's
   generator (each 201 means both copies are written: both holders count
   every needle, and every needle reads back from each); needles deleted
   until ``/admin/vacuum/check`` reads at
   least 0.3 on both holders; ``/vol/vacuum?garbageThreshold=0.3`` while
   64 more uploads (assigned before) run against the volume, so that the
   compaction replays writes that land during its copy; each holder's
   .dat shrank by at least its deleted bytes; every live needle read from
   each holder, each deleted one 404; the replica's server stopped, a
   fresh server with an empty directory started, the shell's
   ``volume.fix.replication -force`` copies the volume back and every
   needle reads from the new copy; ``ec.encode`` retires both copies and
   spreads the shards 5/5/4; reads with the 4-shard server lost;
   ``ec.rebuild``. ``gf_apply`` must launch in the encode, the degraded
   reads and the rebuild, and nowhere else in the phase;
9. (run after 7b) the self-driving warm tier, in its own ``LocalCluster``:
   a master with the repair daemon and the lifecycle rules (warm after 10
   s idle, an evaluation every 0.5 s, decode back at a decayed read rate
   of 270 reads/s, collection ``lctmp`` expiring 3 s after its last write
   plus 1 s of grace; heat half-life 2 s) and 4 volume servers on one
   rack (``Store(coder_name="auto")``, the scrub loop off, pulse 0.5 s),
   no operator command from step 2 on: (1) two volumes of ``lcsmoke``
   allocated on one server, filled at once over HTTP with phase 3's
   generator to 128 MiB each (the size limit; 1 GiB before phase 12, 512
   MiB before phase 13, 256 MiB before phase 14), 5%
   deleted, the first copied aside; (2) the
   daemon seals both and warms them down in one ``ec/fused`` window of
   two (the master's ``lifecycle_encode_windows`` counter), spreads each
   4/4/3/3, reads 14/14 back and retires the originals; the 14 shards
   equal by sha256 a direct ``Store.ec_fused_generate`` of the copy;
   every needle reads back; (3) one byte of a shard flipped on disk:
   ``/admin/ec/scrub`` reports exactly that shard, having checked every
   shard mounted there; the master drops and rebuilds it to its sha256;
   a scrub of every holder checks all 28 shards and finds nothing;
   (4) the server holding 3 shards of the second volume stopped: reads of
   that volume once the master has pruned it (degraded until the
   rebuild), both volumes rebuilt to 14/14 on the survivors, reads of
   both; (5) a 64 MiB volume of ``lcrep`` at ``001``, one holder's copy
   deleted: copied back, every needle read from both holders; (6) a 64
   MiB volume of ``lctmp`` gone from the lookup and the disks after its
   TTL; (7) 8 threads read the first volume's 256 smallest needles until
   the daemon decodes it (``unec``), then its needles read from the
   decoded volume. A read of step 7 may fail only in the decode's window
   (the volume already normal on one holder, the shard set being
   dropped, until the decode's outcome is recorded); the failures are
   counted, by answer, in the ``lifecycle.hot_again`` line. Steps 4 and 7 read a fixed sample: the first needle
   and each 4th after it, in upload order. Each step's line has its
   wall time, GB/s where bytes moved, read p50/p99, launches, the time
   from its trigger to the daemon's action and the card's name and power
   limit. ``gf_apply`` must launch in steps 2-4 (and in the direct
   warm-down and the degraded reads) and nowhere else in the phase;
10. (run after 9) the multi-card coder and the crash sweeps, on two mesh
   members: distinct cards where the host has two or more, else the one
   card twice (two members, each on its own stream). Every line has the
   card's name and power limit. (10a) ``MeshCoder`` against the kernel:
   RS(10,4), RS(20,4) and RS(6,3); widths 1, 1023, 64 KiB + 3 and 8 MiB +
   5 (the pad path); both formulations; the parity matrix and the rebuild
   of victims {0, 3, 7, 12} ({0, 3, 7} at RS(6,3)); every output equal to
   single-card ``gf_apply`` and to the plain version, and the
   formulation's kernel launched once per member per call;
   ``sharded_encode`` and ``sharded_rebuild`` the same bytes. (10b) a
   128 MiB volume (1 GiB before phase 11, 512 MiB before phase 13, 256
   MiB before phase 14) from
   phase 3's generator,
   ``stream_encode`` governed,
   single-card and through the two-member mesh (bitplane, then xorsched):
   the 14 shard files equal by sha256, the plan's ``chips`` 2 and both
   members' staging counters grown, ``stream_rebuild`` of the four
   victims equal by sha256, both device sinks' digests equal to the
   shard files' and the .ecm's; only the formulation's kernel runs, once
   per member per batch (counted); wall time and GB/s per step. (10c)
   under ``WEED_EC_MESH_DEVICES=all``, ``Store(coder_name="auto")`` lifts
   its coder onto a ``MeshCoder`` over every card (a ``TorchCoder`` on a
   one-card host); ``/admin/ec/mesh_status`` of a port volume server and
   shell ``ec.mesh.status`` answer with ``requested``, ``mesh_devices``
   and ``devices``, which names the card. (10d) crash sweeps
   (``seaweedfs_torch.crashsim``) at 2 seeds x 10 crash points each:
   ``ec_encode`` (RS(10,4) at 262144 / 16384 blocks, a 32 MiB seeded .dat,
   ``stream_encode`` with ``get_coder("auto")``), ``fused_warmdown``
   (RS(20,4), a 32 MiB volume of phase 6b's payload kinds, 30%
   tombstoned), ``volume_append``, ``raft_snapshot`` (a master's raft
   state with the metadata log's snapshot folds), ``filer_kv`` (the
   filer's LevelDbStore, its segment compaction the barrier) and
   ``offset_commit`` (replication's consume positions): zero
   violations,
   ``gf_apply`` launched in both EC sweeps and in no other; points,
   violations and wall time per workload;
11. (run after 10) the auto-balancer and the volume server's data path,
   in its own ``LocalCluster``: a master with the repair daemon, a
   lifecycle daemon whose rules fire later than the phase lasts, and the
   balancer (``WEED_BALANCE_INTERVAL=1``, cooldown 30 s; heat half-life
   2 s), 4 volume servers on 2 racks (``Store(coder_name="auto")``, pulse
   0.5 s), volume size limit 40 MiB (256 MiB before phase 12, 192 MiB
   before phase 13, 160 MiB before phase 14, 96 MiB before phase 15, 64
   MiB before phase 18),
   default replication
   ``010``,
   ``WEED_VOLUME_GROUP_COMMIT_US=2000``. Under the operator's admin lease
   (no daemon moves anything meanwhile): (11a) 64 clients upload phase
   3's generator's needles (log-uniform 1 KiB .. 64 KiB; 16 keys per
   assign) until four volumes are full: uploads/s, acknowledgement
   p50/p99 and fsyncs per upload (``os.fsync`` counted); then, into a
   fifth volume, about 900 uploads with group commit off and about 900
   with it on (4000 each before phase 14, 2000 before phase 15, 1500
   before phase 18), side
   by side; every acknowledged needle read back from
   both holders' stores. (11b) read repair on the fifth volume: a byte
   flipped in one holder's copy of a needle reads back good from that
   holder, ``read_crc_repair`` and ``read_repair`` grow by one and the
   next read is local; a needle's index entry dropped on that holder (a
   lost write) reads back repaired. (11c) The four full volumes are
   sealed (shell ``volume.mark -readonly``); the first of two volumes
   held by one node is caught mid-encode there (its shard set generated
   on the card and mounted beside its copies); 8 threads read both
   from that node until shell ``cluster.balance.status``
   ranks it hot (and 4 s at least), then 3 s pass with no move started;
   the lease is released, and reads through the lookup run on while the
   balancer confirms a move over two passes and copies, verifies and
   retires; none may fail; every holder set keeps its two racks; no
   plan names the mid-encode volume, nor does it move (its shards are
   dropped after); every needle of a moved volume reads back from its new
   holder over HTTP; a new volume grows on the coldest node, never the
   hottest; shell ``cluster.balance.run``; moves, bytes moved and
   seconds from the skew to the first completed move. (11d) shell
   ``ec.encode`` of the moved volume on the card, every 8th needle read
   with one shard holder stopped (degraded reads; the repair daemon
   paused for them; every needle before phase 12, every 4th before
   phase 17's room), then the repair daemon's rebuild of the lost shards, each
   holder's ``.ecm`` digests equal to its shard files. (11b, last) the
   repair daemon off and the fifth volume's peer stopped: a needle corrupt on the remaining holder answers 500
   "data corruption" in under 2 s, eight times. (11e) the crash sweep of
   ``volume_group_commit`` at 2 seeds x 20 points (zero violations) and
   the four clustersim scenarios at 1000 nodes (their digests).
   ``gf_apply`` must launch in 11c's mid-encode and in 11d's encode and
   degraded reads, and nowhere else in the phase;
12. (run after 11) the rest of the storage engine, with phase 3's
   generator at log-uniform 1-16 KiB: (12a) a 576 MiB volume (about
   108k needles; 1 GiB before phase 14, 640 MiB before phase 18), 5%
   deleted, under
   ``needle_map_kind="leveldb"`` written with
   ``Store.write_needle`` (the segment flushes counted), the ``.sdx``
   bytes, each kind's open time and RSS growth (``/proc/self/status``),
   the reopen adopting the ``.sdx`` with fewer than ``FLUSH_THRESHOLD``
   entries folded, the (key, offset, size) set equal under ``memory``,
   ``compact`` and ``leveldb``, every 16th live needle read,
   ``ec_generate`` on the card (``.ecm`` digests equal to the shard
   files) with the 14 shards and the ``.ecx`` equal by sha256 to
   ``ec_generate`` of a copy opened as ``memory``, every 16th needle read
   with shards {0, 3, 7, 12} deleted; (12b) an ``archive`` RS(20,4)
   volume of 128 MiB (256 MiB before phase 14) of 6b's payload kinds
   under ``leveldb``, closed (its
   delta flushed), reopened (adopted), 30% tombstoned in the delta over
   the segment, ``ec_fused_generate`` on the card, the 24 shards and the
   decoded compacted .dat equal by sha256 to a ``memory`` copy's;
   (12c) a ``LocalCluster`` of 2 volume servers at ``-index leveldb``:
   16 MiB (64 MiB before phase 13, 32 MiB before phase 15) uploaded by
   8 HTTP clients (5%
   deleted), CLI ``backup``, 500
   uploads and 100 deletes, ``backup`` again applying exactly those 600
   records, the live set equal, and equal again after ``fix`` of the
   backup without its .idx; shell ``volume.tier.upload -dest
   local_store:``: the local .dat gone, every needle read over HTTP
   through ``RemoteFile``, and again after the holder restarts (tiered
   from its ``.vif``); ``volume.tier.download``, shell ``ec.encode`` on
   the card, every 8th needle read with shards {0, 3, 7, 12} deleted;
   the watchdog (``min_free_space_percent=101`` on one server seals its
   volumes, uploads go to the other; back at 0 only its own seal lifts,
   an operator's seal and D9's watchdog-sealed then ec-generated volume
   stay); ``/admin/vacuum/compact`` on a 16 MiB volume 30% deleted,
   first at no rate (then cleaned up), then at a
   ``compaction_byte_per_second`` planned for twice that copy's wall: at
   least bytes/rate of wall, 4 HTTP readers meanwhile, none waiting
   1 s; (12d) the
   ``needle_map_flush`` crash sweep at 2 seeds x 10 points, 0
   violations. ``gf_apply`` must launch in the generates, ``ec.encode``
   and the degraded reads of the phase and nowhere else in it;
13. (run after 12) HA masters, upstream's ``weed master -peers`` layout:
   a ``LocalCluster`` of 3 masters, each with its own raft state
   directory, at the reference's raft timings (elections 0.3-0.6 s,
   heartbeats 0.1 s, ``max_log_entries`` 256), with the repair daemon;
   4 volume servers on 2 racks (``Store(coder_name="auto")``, pulse 0.5
   s) given the masters' list; volume size limit 160 MiB (256 before
   phase 20). (13a) the
   election's seconds; 16 client threads in 4 processes, each a
   ``Client`` over the list, assign and upload phase 3's needles (log-
   uniform 1 KiB .. 4 MiB) into collection ``hasmoke`` until one volume
   is full, while one thread sends 2000 ``/dir/assign?count=1..16``
   round-robin to the three masters (followers proxy; a refused call is
   sent again every 0.02 s); assigns/s and p50/p99 straight to the
   leader and through a follower; the log compacts. (13b) the leader
   stopped once the stream has made 1000 calls or the volume is half
   full: seconds to a new leader and to the first assign sent after the
   stop; no key handed out twice over the phase (every assigned range);
   the first key of the new leader's term equals the old leader's
   applied counter plus the in-flight batches of the old term the new
   leader kept; every acknowledged upload read back from its holder's
   files (every holder's). (13c) the old leader restarted on its state directory (its
   snapshot loaded): a follower whose metadata log equals the others'
   within 10 s, its catch-up seconds. (13d) shell ``ec.encode`` of the
   full volume sent to a follower's URL (proxied, its admin lease taken
   on the leader), shards {0, 3, 7, 12} dropped on their holders with
   the repair daemon paused, every needle read over HTTP (4 reader
   threads, degraded), the repair daemon resumed: it rebuilds the four
   (sha256 equal to the dropped files), then every needle read again.
   A new leader answers assigns 503 for three pulses rather than grow on
   its partial topology, and its daemons wait an admin lease period
   (10 s); the summary line's ``final_term`` counts the elections (2:
   none but 13b's). ``gf_apply`` must launch in 13d's encode, degraded
   reads and rebuild, and in no other step of the phase;
14. (run after 13) the filer and the S3 lifecycle, in its own
   ``LocalCluster``: a master whose lifecycle daemon scans filer A
   (``WEED_LIFECYCLE_FILER``, an evaluation every 0.5 s, a "day" of 1 s;
   the repair daemon off), 4 volume servers on 2 racks
   (``Store(coder_name="auto")``, pulse 0.5 s), volume size limit 64
   MiB, replication ``000``; filer A on ``sqlite`` with 8 MiB chunks,
   filer B on ``memory`` with 64 KiB chunks. (14a) 8 writer threads PUT
   phase 3's generator's files (log-uniform 1 KiB .. 32 MiB) through A
   with ``?collection=b1``: 160 MiB under ``/buckets/b1/arc/``, 8 MiB
   under ``old/``, 32 MiB under ``keep/``; one 80 MiB file through B
   (1280 chunks, folded into one manifest of 1000 and 280 data chunks);
   every file read back whole and by 3 ranges across chunk boundaries
   (B's also across the manifest's edge), equal by sha256; GB/s, p50/p99
   per file, the lease pool's hit rate. (14b) the bucket's rules put on
   its entry through ``/__meta__/update_entry`` (expire ``old/`` after 1
   day, transition ``arc/`` to WARM at 0) while a writer PUTs ``keep2/``
   files; once the ``arc/`` volumes are warm, the writer parks, a late
   4 KiB ``arc/`` file takes a fid from its live lease, and the writer
   resumes when the daemon has sealed that volume: its next chunk POST
   must bounce to a fresh fid (``upload_stale_assignment`` > 0, the
   lease younger than its TTL at the seal); every ``old/`` file answers
   404 and each of its chunks 404 on
   its volume server; every ``arc/`` entry carries WARM; every volume
   holding an ``arc/`` chunk is warmed down by the daemon to 14 shards
   and no server keeps its normal copy; every acknowledged ``keep2/``
   PUT reads back, none refused; seconds
   from the rules' PUT to the first and the last warm ``ok``. (14c)
   shards {0, 3, 7, 12} of each warm volume dropped from their holders
   (kept aside), every ``arc/``, ``keep/`` and ``keep2/`` file read
   through A whole, by a range and chunk by chunk (p50/p99 per file and
   per chunk), then the shards put back and mounted. (14d) the shell's
   ``fs.*`` commands against A: ``fs.ls -l``, ``fs.du`` (the bytes
   written less those expired), ``fs.cat``, ``fs.mv`` of ``keep/`` (its
   files read back), ``fs.rm -r keep2/`` (its chunks freed);
   ``fs.meta.save`` from A and ``fs.meta.load`` into B: equal listings.
   (14e) A restarted on its sqlite file (the listing equal, a read
   equal); ``python3 -m seaweedfs_torch.cli filer -store leveldb2`` as a
   process: one PUT, GET, and ``shell -filer ... fs.ls``; B's 80 MiB file
   deleted: its 1280 data chunks and its manifest freed. ``gf_apply``
   must launch in 14b (the warm-downs) and 14c (the degraded reads), and
   in no other step of the phase;
15. (run after 14) the filer ring, in its own ``LocalCluster``: a master
   whose lifecycle daemon scans filer A (as in 14), 4 volume servers on
   2 racks (``Store(coder_name="auto")``, 64 MiB volumes), and three
   filers on ``sqlite`` at 8 MiB chunks in one ring (64 vnodes, 2
   replicas): A in this process, B and C each ``python3 -m
   seaweedfs_torch.cli filer -ring_peers ...``; the membership set
   through ``/dir/ring/join``. (15a) 16 clients in 4 processes create
   1500 metadata-only entries in 75 directories (20000 in 1000 before
   its first full runs, 8000 in 400 before phase 17, then 5000 in 250,
   3000 in 150 before phase 18, 2000 in 100 before phase 20)
   through ``/__meta__/create_entry``, each op to a random member (about 2/3
   proxied), while a fifth process PUTs 96 MiB of phase 3's generator's
   files (log-uniform 1 KiB .. 8 MiB) under ``/buckets/ring/arc/``
   through random members; an op a member refuses goes again to
   another, a member that refuses connections is dropped by the client;
   creates/s and p50/p99 at the owner and proxied, upload GB/s. (15b) C
   killed (SIGKILL) once 40% of the creates are acknowledged and removed
   with shell ``filer.ring.leave``: seconds from the kill to the last op
   a live member refused; once the survivors' handoff is done, every
   acknowledged entry looked up through each survivor (0 lost) and
   every acknowledged file read back by sha256. (15c) C restarted on
   its store and joined again with shell ``filer.ring.join``; A's
   handoff of the join runs under the ``ring.handoff`` fault, armed
   once A has moved a third of its directories: it fails; cleared, a
   rerun resumes after the watermark (the directories it skipped
   printed, and exactly those after it moved); C's own store holds every
   acknowledged entry of each directory whose replica set it is in;
   shell ``filer.ring.status`` equals ``/dir/ring``. (15d) a recursive
   delete of a tree across partitions (no member's store keeps an entry
   or a child of it, every chunk freed) and a rename across partitions
   (every moved file read back by sha256, the old paths 404); an entry
   cached by the member outside its replica set and changed through its
   owner is seen there within 1 s, long before the 5 s TTL. (15e) a
   bucket rule warms ``arc/`` down to the EC tier on the card; with
   shards {0, 3, 7, 12} of each warm volume dropped, every ``arc/`` file
   read through the member outside its directory's replica set (p50/p99
   per file). ``gf_apply`` must launch in 15e's warm-down and degraded
   reads, and in no other step of the phase;
16. (run after 15) the network stores, in their own ``LocalCluster``:
   a master whose sequencer is a ``KvSequencer`` on a fake redis of its
   own, 2 volume servers (``Store(coder_name="auto")``, 64 MiB volumes),
   and six filers at 8 MiB chunks, one per store (``redis``,
   ``redis2``, ``etcd``, ``mongodb``, ``elastic``, ``cassandra``), each
   on its fake server; the fakes run in processes of their own, and so
   does each filer (``python3 -m seaweedfs_torch.cli filer -store <kind>
   -store_servers ...``).
   (16a) through each filer 8 clients (a process a store) create 1000
   metadata-only entries in 50 directories (``/__meta__/create_entry``):
   creates/s and p50/p99 per store; every directory listed back 100 at
   a time equal to what was acknowledged (0 lost); a rename of a
   directory across directories and a recursive delete, each listed and
   looked up. (16b) 16 MiB of phase 3's generator's files (log-uniform
   1 KiB .. 8 MiB) through each filer under ``/buckets/nets-<store>/``,
   the master restarted halfway: every chunk's key unique, every batch
   minted after the restart above every batch before, the KV counter at
   least the highest key; every volume holding a chunk EC-encoded with
   the shell's ``ec.encode``; shards {0, 3, 7, 12} dropped (kept aside),
   every file read whole through its own filer (p50/p99 per file per
   store), the shards put back. (16c) every filer stopped by SIGTERM and
   started again with its arguments, all at once: each tree lists equal,
   a file reads back through each, ``shell -filer ... fs.ls`` answers
   through the redis2 one. ``gf_apply`` must launch in 16b's encode and
   degraded reads, and in no other step of the phase;
17. (run after 16) upstream's S3 deployment, in its own
   ``LocalCluster``: a master whose lifecycle daemon scans the filer
   (a compressed day of 1 s), 2 volume servers on 2 racks
   (``Store(coder_name="auto")``, 64 MiB volumes), the filer as
   ``python3 -m seaweedfs_torch.cli filer -store leveldb2`` (8 MiB
   chunks) and the gateway as ``python3 -m seaweedfs_torch.cli s3 -filer
   ... -config s3.json`` with two identities, ``admin`` (Admin) and
   ``reader`` (Read, List). Every request is SigV4-signed by this
   script's own signer; 8 clients in 2 processes PUT and GET. (17a) the
   ``warm`` bucket: 64 MiB of phase 3's generator (1 KiB .. 8 MiB) under
   ``arc/`` and ``keep/`` and a few MiB under ``tmp/``, at least 20 of
   them with a streaming chunked-SigV4 body, every object read back by
   sha256 (PUT GB/s, p50/p99 per object; GET p50/p99). (17b) one 40 MiB
   object in 8 MiB parts, ListParts checked before Complete (GB/s);
   CopyObject of 20 objects; 1100 small keys under ``flat/``, 100 of
   them deleted with DeleteObjects, the copies and the other 1000 read
   back by sha256; ListObjectsV2 of ``flat/`` with
   delimiter ``/`` and max-keys 100 paged by continuation token, and of
   the bucket's root, each equal to what is acknowledged and in order
   (p50/p99 per page); a presigned V4 GET and a presigned V2 GET; the
   reader refused a PUT with 403. (17c) the ``ver`` bucket with
   versioning enabled: 200 keys of 1-64 KiB each overwritten once, 50
   deleted (delete markers), every old version read by ``?versionId``,
   ListObjectVersions. (17d) PutBucketLifecycleConfiguration on ``warm``
   (Transition Days 0 WARM for ``arc/``, Expiration Days 1 for
   ``tmp/``): the daemon warms down every volume holding an ``arc/``
   chunk (the encode, on the card; seconds from the rule's PUT to the
   first and the last warm-down), ``tmp/`` objects answer 404 and their
   chunks are freed, ``arc/`` objects list ``WARM``; with shards
   {0, 3, 7, 12} of each warm volume dropped, every ``arc/`` and
   ``keep/`` object read through the gateway by sha256 (p50/p99), the
   shards put back. No answer may be a 5xx and no acknowledged PUT may
   be lost. ``gf_apply`` must launch in 17d's warm-down and degraded
   reads, and in no other step of the phase;
18. (run after 17) the filer's client surfaces, in their own
   ``LocalCluster``: a master, 2 volume servers on 2 racks
   (``Store(coder_name="auto")``, 64 MiB volumes), the filer as
   ``python3 -m seaweedfs_torch.cli filer -store leveldb2`` (8 MiB
   chunks) and the WebDAV gateway as ``python3 -m seaweedfs_torch.cli
   webdav -filer ...``. (18a) 20 collections made with MKCOL, 24 MiB of
   phase 3's generator (1 KiB .. 8 MiB) PUT by 8 clients in 2 processes
   and read back by sha256 (PUT GB/s, p50/p99 per file; GET), 20 files
   moved across collections, a MOVE with ``Overwrite: F`` refused with
   412, one collection copied whole with COPY. (18b) on 10 files: LOCK,
   a PUT without the token answered 423, a PUT with it answered 2xx,
   UNLOCK; then a depth-1 PROPFIND of each collection lists exactly its
   files with their sizes (p50/p99). (18c) the mount as an in-process
   ``WFS`` (8 MiB chunks): 16 MiB in files, the first at the
   generator's top size, each written in seeded pieces of 4 KiB .. 1 MiB
   out of order with overlaps (a full chunk's dirty pages flush early),
   one file truncated and one renamed while open, each read back before
   its release against a ``bytearray`` model; an xattr set on 5 files,
   5 hard-linked and their first names unlinked. (18d) 8 MiB through
   the fsspec adapter (``fs.open(..., "wb")`` and ``pipe_file``), ``ls``
   and ``info`` checked. (18e) 2000 JSON documents of 200 B .. 4 KiB
   uploaded to collection ``docs`` with the client (fids from the
   threaded ``AssignLeasePool`` over ``/dir/assign?count=N``), three
   ``Client.query`` calls with projections (``n < 500``, ``a.b = 7``,
   ``tag contains "x"``) equal to the answers known by construction.
   (18f) where the host serves a FUSE mount (a probe filesystem through
   the port's libfuse2 binding mounts, else a ``skipped`` line), the
   CLI ``mount`` on a kernel mount point and 3 files copied in with
   ``open()``. (18g) every volume holding a file of the phase encoded
   with the shell's ``ec.encode``; shards {0, 3, 7, 12} dropped. (18h)
   every file read back with 4 shards lost: through WebDAV (p50/p99),
   a fresh ``WFS`` (xattrs and links too), fsspec (whole and by ranges),
   the kernel mount, and the three queries again. No answer may be a
   5xx. ``gf_apply`` must launch in 18g's encode and in each read with 4
   shards lost whose files have a needle on a lost shard (the fresh
   mount's reads and the queries must), and in no other step;
19. (run after 18) upstream's cross-cluster deployment, cut in scale
   only: two clusters, each its own ``LocalCluster`` (a master whose geo
   daemon scans its filer, 2 volume servers on 2 racks,
   ``Store(coder_name="auto")``, 64 MiB volumes) with its filer as
   ``python3 -m seaweedfs_torch.cli filer -store leveldb2`` (8 MiB
   chunks); the primary's filer reads a ``notification.toml``
   (``[notification.file]``, a spool), and the primary has the gateway
   as ``python3 -m seaweedfs_torch.cli s3`` with
   ``WEED_GEO_REPLICA_FILER`` naming the replica's filer. (19a) a
   versioned bucket: 32 MiB of phase 3's generator (1 KiB .. 8 MiB) PUT
   by 4 clients in 2 processes, half before its PutBucketReplication
   rule (naming the replica's filer) and half after. (19b) every primary
   volume holding an object encoded with the shell's ``ec.encode``;
   shards {0, 3, 7, 12} dropped. (19c) ``/geo/run``: the job backfills
   the bucket (its source reads with 4 shards lost), passes until its
   lag is 0; both namespaces equal, every file by sha256. (19d) the
   tail: first a steady segment, 100 small new objects (200 before phase
   20; 1-4 KiB, under
   8 prefixes) by 4 clients with both filers up, whose lag from each
   PUT's answer to its version on the replica (p50/p99) and events/s are
   the phase's replication metrics; then the drill: 6 overwrites, 4 new
   objects and 4 versioned deletes by 4 clients, the replica's filer
   SIGKILLed once a third of them have replicated (as the reference's
   drill) and started again after two thirds (its lag printed apart);
   the namespaces equal again. (19f) CLI ``filer.replicate
   -from_queue`` starts draining the spool of the whole bucket
   (``gone/`` included: a queued create whose path was deleted since is
   skipped, D27) into a ``LocalSink`` directory, beside (19e) a second
   bucket with a rule each way: 4 objects written on each side reach the
   other, and the jobs stop moving; the drain is stopped once its tree
   equals the primary's file by file. (19g) the
   replica's volumes encoded, the same 4 shards dropped, the primary's
   filer and master stopped: every object and every version read back
   through ``Client(replica_masters=)`` and through the gateway, each
   marked stale and equal by sha256 (p50/p99). Then ``offset_commit``'s
   crash sweep. No acknowledged PUT lost, no event applied twice or
   looped back (every job apply is recorded), no 5xx. ``gf_apply`` must
   launch in both encodes, in the backfill and both failover reads when
   a needle lies on a lost shard, and in no other kernel;
20. (run after 19) the gRPC planes and the message broker, upstream's
   default wiring cut in scale only: a ``LocalCluster`` (a master and 3
   volume servers on 2 racks, ``Store(coder_name="auto")``, 64 MiB
   volumes, every server with its gRPC port at its HTTP port + 10000,
   the volume servers beating over the master's gRPC Heartbeat stream),
   a CLI filer (``leveldb2``, 8 MiB chunks, its gRPC port) whose
   ``notification.toml`` names ``[notification.broker]``, and two CLI
   ``msg.broker`` processes registered over the filer's gRPC
   KeepConnected (``/__meta__/brokers`` lists both). (20a) Assign,
   Lookup, ClusterStatus and KeepConnected (the snapshot, then the delta
   of a new volume) over gRPC. (20b) 120 JSON documents, then 24 MiB of
   phase 3's generator (1 KiB .. 8 MiB), PUT through the filer by 4
   clients, each PUT answered once its events are on the broker; the
   documents open the volumes, so they lie on shard 0, one of the lost;
   the filer's events go through the broker topic into
   ``filer.replicate``'s ``[source.broker]`` input (in this process) and
   a ``LocalSink``: the tree equal, every event applied once. (20c) the
   volumes encoded with every step a volume server's gRPC call
   (VolumeMarkReadonly, VolumeEcShardsGenerate, VolumeEcShardsCopy,
   VolumeEcShardsMount, VolumeDelete, VolumeEcShardsDelete), then
   VolumeEcShardsDelete of {0, 3, 7, 12}. (20d) every needle read back
   through the client (p50/p99), each survivor interval fetched over
   VolumeEcShardRead (``ec_shard_fetch{route="http"}`` 0, ``grpc`` above
   0), then the same reads with the peers' gRPC ports taken for dead
   (HTTP only), and Query over gRPC equal to ``/admin/query``. (20e)
   VolumeEcShardsRebuild over gRPC after VolumeEcShardsCopy of the
   survivors; the rebuilt files equal the encode's and the plain
   version's reconstruction. (20f) 200 publishes at each ack level; 200
   ``ack=flush`` publishes to a partition one broker owns, that broker
   SIGKILLed after a third: the survivor owns it, a subscriber resumes
   from the filer's segments, no acknowledged message is lost; the
   topic's volumes encoded over gRPC with 4 shards lost, and the topic
   replays whole. (20g) the same events through ``fake_kafka`` with
   ``KafkaQueue`` -> ``KafkaQueueInput``: every event applied once, the
   tree equal. Needles and documents must lie on the lost shards;
   ``gf_apply`` must launch in both encodes and the rebuild, in the
   reads and Query, in the replay where a segment lies on a lost shard,
   and no other kernel anywhere;
5. the kernels' times and the plain versions' (CUDA events, median of
   windows after warm-up) and the wrappers' host time per call at the
   shapes the main path gives them (RS(20,4) at [20, 8 MiB] and at the
   fused pass's [20, 4 MiB] too), with and without the digest epilogue
   (beside the kernel-then-``sum`` pass the epilogue replaces), and the
   bound: bytes at the memory rate, or the function's operations at their
   rate, whichever takes longer. For ``gf_apply`` and the XOR-schedule
   kernel (one function) the operations are the XORs of the matrix's
   schedule, one 32-bit word operation per XOR per 32 columns, at the
   32-bit integer rate (132 SMs x 64 per clock x the SM clock nvidia-smi
   reports): a count of the function, not of either kernel's design.
   ``gf_apply``'s own integer instructions per column, counted from the
   built library's SASS, are reported beside it (``ops_per_column``), and
   so are the tensor-core kernel's mma and integer instructions per 16
   columns at RS(10,4) (``sass_per_16_columns``, on wgmma and on
   mma.sync, whose time is ``mma_sync_ms``), whose bound counts the
   int8 operations the function needs (the GF product and the repack,
   without the design's padding) at the tensor-core rate. The
   nvidia-smi line, the ``kernels`` line, the ``phase_seconds`` line
   (each phase's wall seconds, the kernels' times as "5"), and the
   result line.

It needs one card, exits non-zero without one, and works in a scratch
directory inside the checkout that it removes at the end.
"""

from __future__ import annotations

import asyncio
import collections
import functools
import gc
import hashlib
import itertools
import json
import multiprocessing as mp
import queue
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from seaweedfs_torch import faults, observe
from seaweedfs_torch.client import Client, ClientError
from seaweedfs_torch import balance as balance_mod
from seaweedfs_torch.balance import daemon as balance_daemon
from seaweedfs_torch.client import _get_json as http_get_json
from seaweedfs_torch.clustersim import scenarios as sim_scenarios
from seaweedfs_torch.crashsim import harness as crash_harness
from seaweedfs_torch.crashsim import workloads as crash_wl
from seaweedfs_torch.ec import coder as coder_mod
from seaweedfs_torch.ec import ec_volume, feed, geometry, governor
from seaweedfs_torch.ec import pipeline, striping
from seaweedfs_torch.observe import wideevents
from seaweedfs_torch.lifecycle import LifecycleConfig
from seaweedfs_torch.parallel import mesh_coder as mesh_mod
from seaweedfs_torch.parallel import sharded
from seaweedfs_torch.ops import _build, gf256, rs_cuda, rs_torch
from seaweedfs_torch.ops import xor_schedule
from seaweedfs_torch.server import http
from seaweedfs_torch.server.local_cluster import LocalCluster
from seaweedfs_torch.shell import commands as shell_commands
from seaweedfs_torch.shell.ec_commands import EcCommands
from seaweedfs_torch.storage import idx as idx_mod
from seaweedfs_torch.storage import store as store_mod
from seaweedfs_torch.storage import types as st_types
from seaweedfs_torch.storage.file_id import FileId
from seaweedfs_torch.storage.needle import (FLAG_HAS_MIME, FLAG_HAS_NAME,
                                            FLAG_IS_COMPRESSED, Needle)
from seaweedfs_torch.storage.needle_map import DiskNeedleMap
from seaweedfs_torch.storage.superblock import SuperBlock
from seaweedfs_torch.storage.volume import Volume
from seaweedfs_torch.utils import compression, metrics

REPO = Path(__file__).resolve().parent
WORK = REPO / ".chip_smoke_work"
SEED = 20261016
VICTIMS = (0, 3, 7, 12)
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor rate
# 32-bit integer add and logic results per clock per SM at compute
# capability 9.0 (CUDA C Programming Guide, arithmetic instructions)
INT32_RESULTS_PER_CLOCK_PER_SM = 64
# set in main(): the card's 32-bit integer rate (word_ops_per_s),
# gf_apply's SASS instruction counts and the tensor-core kernel's per 16
# columns (sass_ops)
WORD_OPS = [0.0]
SASS_OPS: dict = {}
MXU_SASS: dict = {}
KERNELS = {
    "gf_apply": {
        "name": "gf_apply",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_apply.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:46",
    },
    "gf_apply_xorsched": {
        "name": "gf_apply_xorsched",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_xorsched.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:65",
    },
    "gf_apply_mxu": {
        "name": "gf_apply_mxu",
        "route": "cuda",
        "source": "seaweedfs_torch/csrc/gf_mxu.cu",
        "replaces": "seaweedfs_tpu/ops/rs_pallas.py:109",
    },
}
WRAPPERS = {"gf_apply": rs_cuda.gf_apply,
            "gf_apply_xorsched": rs_cuda.gf_apply_xorsched,
            "gf_apply_mxu": rs_cuda.gf_apply_mxu}
FORMULATION_KERNEL = {"bitplane": "gf_apply",
                      "xorsched": "gf_apply_xorsched"}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def word_ops_per_s() -> float:
    """The card's 32-bit integer add/logic rate: its SMs x 64 results per
    clock x the SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_RESULTS_PER_CLOCK_PER_SM * mhz * 1e6


def sass_ops(lib: Path) -> tuple[dict, dict]:
    """From the built library's SASS (scripts/torch_sass_ops.py):
    gf_apply_vec16's integer-pipe instructions -- the row-pair loop's (two
    input rows of 16 columns: the loop with global loads and the most
    shared loads) and the rest of the enclosing column-group loop's (16
    columns: the transposes, stores and digest) -- and the tensor-core
    kernel's instructions per 16 columns and row group at RS(10,4), by
    class (mma, alu, ...), on wgmma and on mma.sync."""
    sys.path.insert(0, str(REPO / "scripts"))
    import torch_sass_ops as so
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    insns = next(v for k, v in so.kernels(sass).items()
                 if "gf_apply_vec16" in k)

    def count(span, cls):
        return sum(1 for a, op, _ in insns
                   if span[0] <= a <= span[1] and so.classify(op) == cls)

    spans = so.loops(insns)
    # the innermost of the loops with the most shared loads and any
    # global load
    inner = max((sp for sp in spans if count(sp, "global_or_local")),
                key=lambda sp: (count(sp, "shared"), sp[0] - sp[1]))
    outer = min((sp for sp in spans if sp != inner and sp[0] <= inner[0]
                 and inner[1] <= sp[1]), key=lambda sp: sp[1] - sp[0])
    return ({"row_pair_loop": count(inner, "alu"),
             "column_group_rest": count(outer, "alu") - count(inner, "alu")},
            {"wgmma": so.mxu_counts(sass, wgmma=True),
             "mma.sync": so.mxu_counts(sass, wgmma=False)})


def gf_apply_ops_per_column(cols: int) -> float | None:
    """Integer instructions per byte column (one row group of up to four
    output rows) at C input rows, from the SASS counts."""
    if not SASS_OPS:
        return None
    pairs = (cols + 1) // 2
    return (pairs * SASS_OPS["row_pair_loop"]
            + SASS_OPS["column_group_rest"]) / 16


def bound_ms_mxu(rows: int, cols: int, n: int) -> tuple[float, str]:
    """Least time for the tensor-core variant: the same bytes, against
    the int8 operations the function needs at the tensor-core rate: the
    GF product's 2*8R*8C*n and the repack's 2*R*8R*n (the kernel's one u8
    product and the reference's two nibble products 2*2*R*4R*n alike),
    with none of the design's padding of K or N counted."""
    t_bytes = (cols + rows) * n / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * (8 * rows) * (8 * cols) * n + 2 * rows * (8 * rows) * n
             ) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(sched, rows: int, cols: int, n: int) -> tuple[float, str]:
    """Least time for a matrix [R, C] applied to [C, n] (gf_apply and
    the XOR-schedule kernel): input read once and output written once at
    the memory rate, against the XORs of the matrix's schedule, one 32-bit
    word operation per XOR per 32 columns, at the 32-bit integer rate."""
    t_bytes = (cols + rows) * n / HBM_BYTES_PER_S * 1e3
    t_ops = (sched.sched_xors * xor_schedule.packed_width(n)
             / WORD_OPS[0] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def program(mat: np.ndarray, device: torch.device):
    """The grouped XOR program of a coefficient matrix (the coder's
    operand), on `device`."""
    return xor_schedule.lower_schedule_grouped(
        xor_schedule.schedule_for_matrix(mat)).to(device)


def time_cuda(fn, reps: int, warm: int = 3,
              windows: int = 5) -> tuple[float, float]:
    """(ms per call on the device, us per call on the host): CUDA events
    and the host clock (before the closing synchronize), medians over
    `windows` windows of `reps` back-to-back calls each, after `warm`
    calls of warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    per_call, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) / reps * 1e6)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call)), float(np.median(host))


class call_counter:
    """Count the calls of obj.name during a block, and keep what they
    returned; the function itself still runs."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls, self.results = obj, name, 0, []

    def __enter__(self):
        self.real = getattr(self.obj, self.name)

        def counting(*args, **kwargs):
            self.calls += 1
            result = self.real(*args, **kwargs)
            self.results.append(result)
            return result

        setattr(self.obj, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def lost(k: int, m: int) -> tuple[tuple, tuple]:
    """(survivors, victims) when shards VICTIMS are lost."""
    victims = tuple(v for v in VICTIMS if v < k + m)[:m]
    return tuple(i for i in range(k + m) if i not in victims)[:k], victims


def padded_rec(k: int, m: int) -> np.ndarray:
    present, victims = lost(k, m)
    rec = gf256.reconstruction_matrix(k, m, present, victims)
    return np.vstack([rec, np.zeros((m - rec.shape[0], k), np.uint8)])


def one_row_rec(k: int, m: int) -> np.ndarray:
    """The unpadded [1, k] matrix that a degraded read of an interval on
    one lost shard gives the kernel."""
    present, victims = lost(k, m)
    return gf256.reconstruction_matrix(k, m, present, victims[:1])


# --- phase 2: the kernels against their plain versions ------------------

def check_digests(w, prog, x: torch.Tensor, case: str) -> None:
    """Both digest kernels' [C + R] sums, with and without output stores
    (the second launch adds to the first), against the plain digest."""
    want = rs_torch.gf_apply_digest(w, x)[1]
    for name, kernel, operand in [
            ("gf_apply", rs_cuda.gf_apply, w),
            ("gf_apply_xorsched", rs_cuda.gf_apply_xorsched, prog)]:
        d = rs_cuda.new_digest(len(want), x.device)
        kernel(operand, x, digest=d)
        once = rs_cuda.digest_values(d)
        if kernel(operand, x, digest=d, out=False) is not None:
            raise AssertionError(f"{name}: out=False returned an output")
        twice = rs_cuda.digest_values(d)
        if not (torch.equal(once, want)
                and torch.equal(twice, (2 * want) & 0xFFFFFFFF)):
            raise AssertionError(f"{name} digest != plain at {case}")


def check_kernels(device: torch.device) -> dict:
    """Every kernel against its plain version (and the XOR-schedule and
    tensor-core kernels against gf_apply) on the same inputs, and the
    digest epilogues against the plain digests; returns, per kernel, the
    largest absolute difference and the number of cases."""
    rng = np.random.default_rng(SEED)
    worst = {name: 0 for name in KERNELS}
    cases = 0
    for k, m in [(10, 4), (20, 4), (6, 3)]:
        for n in [1, 1023, 64 * 1024 + 3, MIB + 5, 8 * MIB, 16 * MIB]:
            x = torch.from_numpy(
                rng.integers(0, 256, (k, n), dtype=np.uint8)).to(device)
            for mat in [gf256.parity_matrix(k, m), padded_rec(k, m),
                        one_row_rec(k, m)]:
                w = rs_torch.load_matrix(mat, device)
                prog = program(mat, device)
                got = rs_cuda.gf_apply(w, x)
                got_x = rs_cuda.gf_apply_xorsched(prog, x)
                got_m = rs_cuda.gf_apply(w, x, repack="mxu")
                got_s = rs_cuda.gf_apply_mxu(w, x, instr="mma")
                torch.cuda.synchronize()
                pairs = {"gf_apply": (got, rs_torch.gf_apply(w, x)),
                         "gf_apply_xorsched": (got_x, rs_torch.
                                               gf_apply_xorsched(
                                                   prog.sched, x)),
                         "gf_apply_mxu": (got_m,
                                          rs_torch.gf_apply_mxu(w, x))}
                for name, (a, b) in pairs.items():
                    err = int((a.int() - b.int()).abs().max())
                    worst[name] = max(worst[name], err)
                    if err:
                        raise AssertionError(
                            f"{name} != plain at RS({k},{m}) n={n} "
                            f"matrix {mat.shape}: max abs err {err}")
                for name, other in [("gf_apply_xorsched", got_x),
                                    ("gf_apply_mxu", got_m),
                                    ("gf_apply_mxu on mma.sync", got_s)]:
                    if not torch.equal(got, other):
                        raise AssertionError(
                            f"{name} != gf_apply at RS({k},{m}) n={n} "
                            f"matrix {mat.shape}")
                check_digests(w, prog, x, f"RS({k},{m}) n={n} matrix "
                              f"{mat.shape}")
                cases += 1
    log({"phase": "kernels_vs_plain", "cases_per_kernel": cases,
         "bit_equal": True, "xorsched_equals_gf_apply": True,
         "mxu_equals_gf_apply": True, "mxu_mma_sync_equals_gf_apply": True,
         "max_abs_err": worst,
         "digests_equal_plain": ["gf_apply", "gf_apply_xorsched"],
         "digest_only_launches_equal_plain": True})
    return {"max_abs_err": worst, "cases": cases}


def time_kernels(device: torch.device, shapes: list) -> dict:
    """Each kernel's and its plain version's times at main-path shapes
    [(label, R, C, n)], on the same inputs, and the two digest kernels'
    launches with the epilogue beside the kernel-then-sum pass it
    replaces; {kernel: [rows]}."""
    rng = np.random.default_rng(SEED + 1)
    out: dict = {name: [] for name in KERNELS}
    for label, rows, cols, n in shapes:
        x = torch.from_numpy(
            rng.integers(0, 256, (cols, n), dtype=np.uint8)).to(device)
        mat = (gf256.parity_matrix(cols, rows)
               if label.startswith(("encode", "archive"))
               else padded_rec(cols, rows) if label == "rebuild"
               else one_row_rec(cols, 4))
        w = rs_torch.load_matrix(mat, device)
        prog = program(mat, device)
        d = rs_cuda.new_digest(rows + cols, device)
        runs = {
            "gf_apply": (lambda: rs_cuda.gf_apply(w, x),
                         lambda: rs_torch.gf_apply(w, x),
                         bound_ms(prog.sched, rows, cols, n)),
            "gf_apply_xorsched": (
                lambda: rs_cuda.gf_apply_xorsched(prog, x),
                lambda: rs_torch.gf_apply_xorsched(prog.sched, x),
                bound_ms(prog.sched, rows, cols, n)),
            "gf_apply_mxu": (lambda: rs_cuda.gf_apply(w, x, repack="mxu"),
                             lambda: rs_torch.gf_apply_mxu(w, x),
                             bound_ms_mxu(rows, cols, n)),
        }
        digest_runs = {
            "gf_apply": (
                lambda: rs_cuda.gf_apply(w, x, digest=d),
                lambda: rs_cuda.gf_apply(w, x, digest=d, out=False),
                lambda: rs_cuda.gf_apply(w, x).sum(dim=1,
                                                   dtype=torch.int64)),
            "gf_apply_xorsched": (
                lambda: rs_cuda.gf_apply_xorsched(prog, x, digest=d),
                lambda: rs_cuda.gf_apply_xorsched(prog, x, digest=d,
                                                  out=False),
                lambda: rs_cuda.gf_apply_xorsched(prog, x).sum(
                    dim=1, dtype=torch.int64)),
        }
        # a window moves about 20 GB through the kernel (some ms of work)
        reps = max(50, min(2000, int(2e10 // max(n * (rows + cols), 1))))
        for name, (kernel, plain, (b_ms, b_by)) in runs.items():
            ms, host_us = time_cuda(kernel, reps, warm=reps)
            plain_ms, _ = time_cuda(plain, max(3, reps // 40), warm=1,
                                    windows=3)
            row = {"phase": "kernel_time", "kernel": name, "shape": label,
                   "in": [cols, n], "out": [rows, n], "ms": ms,
                   "host_us": host_us, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "reps": reps}
            if name == "gf_apply":
                row["ops_per_column"] = gf_apply_ops_per_column(cols)
            if name == "gf_apply_mxu":
                row["sass_per_16_columns"] = MXU_SASS or None
                # the same kernel on mma.sync, beside it
                row["mma_sync_ms"], _ = time_cuda(
                    lambda: rs_cuda.gf_apply_mxu(w, x, instr="mma"), reps,
                    warm=reps)
            if name in digest_runs:
                with_d, only_d, then_sum = digest_runs[name]
                row["digest_ms"], row["digest_host_us"] = time_cuda(
                    with_d, reps, warm=reps)
                row["digest_only_ms"], _ = time_cuda(only_d, reps, warm=reps)
                # the digest part's yardstick: the kernel, then one
                # PyTorch row sum over its output
                row["digest_library_ms"], _ = time_cuda(then_sum, reps,
                                                        warm=reps)
            log(row)
            out[name].append(row)
    return out


# --- phases 3 and 4: the main path ------------------------------------

def payload(seed: int, nid: int, size: int) -> bytes:
    return np.random.default_rng((seed, nid)).bytes(size)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(16 * MIB)
            if not chunk:
                return h.hexdigest()
            h.update(chunk)


def write_needles(write, delete, size_now, total: int, max_needle: int,
                  seed: int) -> tuple[dict, set]:
    """Seeded needles, log-uniform 1 KiB .. max_needle, written with
    `write` until size_now() reaches `total`; then about 5% deleted."""
    rng = np.random.default_rng(seed)
    sizes: dict = {}
    nid = 0
    while size_now() < total:
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - size_now())
        write(Needle(cookie=nid * 7919 & 0xFFFFFFFF, id=nid,
                     data=payload(seed, nid, size)))
        sizes[nid] = size
    deleted = {int(i) for i in rng.choice(
        sorted(sizes), size=max(1, len(sizes) // 20), replace=False)}
    for d in sorted(deleted):
        delete(Needle(cookie=d * 7919 & 0xFFFFFFFF, id=d))
    return sizes, deleted


def write_volume(directory: str, total: int, max_needle: int,
                 seed: int) -> tuple[dict, set]:
    """write_needles into volume 1 of `directory` through the Volume."""
    vol = Volume(directory, "", 1, create=True)
    try:
        return write_needles(vol.write_needle, vol.delete_needle,
                             vol.data_file_size, total, max_needle, seed)
    finally:
        vol.close()


def read_all(vol, sizes: dict, deleted: set, seed: int) -> dict:
    """Every live needle byte-identical, every deleted one refused;
    returns the bytes read and each live read's latency."""
    nbytes, lat = 0, []
    for nid, size in sizes.items():
        if nid in deleted:
            try:
                vol.read_needle(nid)
            except KeyError:
                continue
            raise AssertionError(f"deleted needle {nid} still readable")
        t0 = time.perf_counter()
        n = vol.read_needle(nid, cookie=nid * 7919 & 0xFFFFFFFF)
        lat.append(time.perf_counter() - t0)
        if n.data != payload(seed, nid, size):
            raise AssertionError(f"needle {nid} reads back wrong")
        nbytes += size
    return {"bytes": nbytes, "latencies": lat}


def latency_summary(lat: list) -> dict:
    ms = np.sort(np.asarray(lat)) * 1e3
    return {"reads": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms[-1])}


def needles_on(vol, sizes: dict, deleted: set, shards: tuple) -> int:
    """Live needles with at least one interval on the given shards."""
    count = 0
    for nid in sizes:
        if nid in deleted:
            continue
        _, _, intervals = vol.locate(nid)
        if any(iv.to_shard_id_and_offset(vol.g)[0] in shards
               for iv in intervals):
            count += 1
    return count


def check_parity_with(base: str, g: geometry.Geometry,
                      device: torch.device, apply=rs_torch.gf_apply) -> int:
    """Every parity byte on disk equals apply(W, data) of the data shards
    on disk in [k, 8 MiB] batches, computed on `device` (the plain
    version by default)."""
    w = rs_torch.load_matrix(gf256.parity_matrix(g.data_shards,
                                                 g.parity_shards), device)
    files = [open(base + geometry.to_ext(i), "rb")
             for i in range(g.total_shards)]
    try:
        size = os.path.getsize(base + geometry.to_ext(0))
        for off in range(0, size, 8 * MIB):
            rows = [np.frombuffer(f.read(min(8 * MIB, size - off)), np.uint8)
                    for f in files]
            data = torch.from_numpy(np.stack(rows[:g.data_shards]))
            want = apply(w, data.to(device)).cpu().numpy()
            if not np.array_equal(want, np.stack(rows[g.data_shards:])):
                raise AssertionError(f"parity differs from {apply.__name__}"
                                     f" at shard offset {off}")
        return size
    finally:
        for f in files:
            f.close()


def timed(name: str, fn, nbytes_fn=None, extra=None):
    """Run one step, log its wall time (and GB/s over nbytes)."""
    t0 = time.perf_counter()
    result = fn()
    secs = time.perf_counter() - t0
    row = {"phase": name, "seconds": secs}
    nbytes = nbytes_fn(result) if nbytes_fn else None
    if nbytes:
        row["bytes"] = nbytes
        row["gbps"] = nbytes / secs / 1e9
    row.update(extra(result) if extra else {})
    log(row)
    return result


def counted(fn):
    """(result, {kernel: launches during fn}) with every count set to 0
    first."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    result = fn()
    return result, {name: w.launches for name, w in WRAPPERS.items()}


def check_sinks(base: str, coder, g: geometry.Geometry, tag: str) -> dict:
    """Both device sinks on the finished volume: the encode digest must
    equal the parity files' and the .ecm's, the rebuild digest of the
    four victims the victims' files' and the .ecm's; neither runs a
    torch.sum (the digest-only launches add into one buffer). Returns
    launches."""
    stamped = pipeline.read_stamped_digests(base)
    launches = {}
    stats: dict = {}
    with call_counter(torch.Tensor, "sum") as sums:
        digest, launches["encode_sink"] = timed(
            f"{tag}encode_device_sink",
            lambda: counted(lambda: pipeline.stream_encode_device_sink(
                base, coder, g, stats=stats)),
            lambda r: os.path.getsize(base + ".dat"),
            lambda r: {"launches": r[1], "stats": stats})
    if sums.calls:
        raise AssertionError(f"encode sink ran {sums.calls} torch.sum")
    want = pipeline.parity_file_digest(base, g)
    if not (np.array_equal(digest, want) and digest.tolist() == [
            stamped[i] for i in range(g.data_shards, g.total_shards)]):
        raise AssertionError(f"encode sink digest {digest.tolist()} != "
                             f"files {want.tolist()} / .ecm {stamped}")
    stats = {}
    with call_counter(torch.Tensor, "sum") as sums:
        digest, launches["rebuild_sink"] = timed(
            f"{tag}rebuild_device_sink",
            lambda: counted(lambda: pipeline.stream_rebuild_device_sink(
                base, coder, VICTIMS, g, stats=stats)),
            lambda r: os.path.getsize(base + geometry.to_ext(1))
            * g.data_shards, lambda r: {"launches": r[1], "stats": stats})
    if sums.calls:
        raise AssertionError(f"rebuild sink ran {sums.calls} torch.sum")
    want = pipeline.shard_file_digest(base, VICTIMS)
    if not (np.array_equal(digest, want)
            and digest.tolist() == [stamped[v] for v in VICTIMS]):
        raise AssertionError(f"rebuild sink digest {digest.tolist()} != "
                             f"files {want.tolist()} / .ecm {stamped}")
    return launches


def source_volume(work: Path, total: int, max_needle: int, seed: int,
                  tag: str) -> dict:
    """Write one seeded volume that each formulation's run copies (needle
    records carry their append time, so two writes of one seed differ)."""
    work.mkdir(parents=True, exist_ok=True)
    sizes, deleted = timed(
        f"{tag}write_volume",
        lambda: write_volume(str(work), total, max_needle, seed),
        lambda r: os.path.getsize(os.path.join(str(work), "1.dat")),
        lambda r: {"needles": len(r[0]), "deleted": len(r[1])})
    return {"dir": work, "sizes": sizes, "deleted": deleted, "seed": seed}


def run_main_path(work: Path, coder, g: geometry.Geometry, volume: dict,
                  device: torch.device, tag: str,
                  min_on_victims: int = 1) -> tuple[dict, dict]:
    """Encode, verify, serve (whole and degraded), rebuild, decode and
    sink a copy of a source volume; returns the launches of both kernels
    per step and the sha256 of each shard file as encoded."""
    shutil.copytree(volume["dir"], work)
    directory = str(work)
    base = os.path.join(directory, "1")
    sizes, deleted, seed = volume["sizes"], volume["deleted"], volume["seed"]
    launches = {}
    dat_size = os.path.getsize(base + ".dat")
    src_sha = sha256_file(base + ".dat")

    # the .ecm digests come from the kernels' digest epilogue: the host
    # sum is never called
    with call_counter(pipeline, "host_row_digests") as host_sums:
        _, launches["encode"] = timed(
            f"{tag}stream_encode",
            lambda: counted(lambda: pipeline.stream_encode(base, coder, g)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
    stamped = pipeline.read_stamped_digests(base)
    files = pipeline.shard_file_digest(base, range(g.total_shards))
    if host_sums.calls or [stamped.get(i) for i in range(g.total_shards)] \
            != files.tolist():
        raise AssertionError(f"{tag}encode digests: {host_sums.calls} host "
                             f"sums; .ecm {stamped} != files "
                             f"{files.tolist()}")
    log({"phase": f"{tag}ecm_digests", "from": "kernel digest epilogue",
         "host_sum_calls": host_sums.calls,
         "equal_shard_file_digest": True})
    striping.write_sorted_ecx_from_idx(base)
    shard_sha = {i: sha256_file(base + geometry.to_ext(i))
                 for i in range(g.total_shards)}
    timed(f"{tag}parity_vs_plain",
          lambda: check_parity_with(base, g, device),
          lambda shard: shard * g.total_shards)

    vol = ec_volume.EcVolume(directory, "", 1, g, coder=coder)
    try:
        for sid in range(g.total_shards):
            vol.add_shard(sid)
        timed(f"{tag}read_all_shards",
              lambda: read_all(vol, sizes, deleted, seed),
              lambda r: r["bytes"],
              lambda r: latency_summary(r["latencies"]))
        on_victims = needles_on(vol, sizes, deleted, VICTIMS)
    finally:
        vol.close()

    for v in VICTIMS:
        os.remove(base + geometry.to_ext(v))
    vol = ec_volume.EcVolume(directory, "", 1, g, coder=coder)
    try:
        for sid in range(g.total_shards):
            if sid not in VICTIMS:
                vol.add_shard(sid)
        _, launches["degraded_read"] = timed(
            f"{tag}read_degraded",
            lambda: counted(lambda: read_all(vol, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], "needles_on_victims": on_victims,
                       **latency_summary(r[0]["latencies"])})
    finally:
        vol.close()
    if on_victims < min_on_victims:
        raise AssertionError(
            f"degraded reads: {on_victims} needles on the lost shards "
            f"(want {min_on_victims})")

    rebuilt, launches["rebuild"] = timed(
        f"{tag}stream_rebuild",
        lambda: counted(lambda: pipeline.stream_rebuild(base, coder, g)),
        lambda r: os.path.getsize(base + geometry.to_ext(1))
        * g.data_shards, lambda r: {"launches": r[1]})
    if rebuilt != list(VICTIMS):
        raise AssertionError(f"rebuilt {rebuilt}, expected {VICTIMS}")
    for v in VICTIMS:
        if sha256_file(base + geometry.to_ext(v)) != shard_sha[v]:
            raise AssertionError(f"rebuilt shard {v} differs")

    os.replace(base + ".dat", base + ".dat.src")
    timed(f"{tag}write_dat_file",
          lambda: striping.write_dat_file(base, dat_size, g),
          lambda r: dat_size)
    if (os.path.getsize(base + ".dat") != dat_size
            or sha256_file(base + ".dat") != src_sha):
        raise AssertionError("decoded .dat differs from the source")
    found = striping.find_dat_file_size(base, st_types.CURRENT_VERSION)
    if not 0 < found <= dat_size:
        raise AssertionError(f"find_dat_file_size {found} > {dat_size}")
    launches.update(check_sinks(base, coder, g, tag))
    # every step ran the coder's kernel and no other
    mine = FORMULATION_KERNEL[coder.formulation]
    for step, counts in launches.items():
        if counts[mine] == 0 or any(n for name, n in counts.items()
                                    if name != mine):
            raise AssertionError(f"{tag}{step}: launches {counts}, want "
                                 f"only {mine}")
    log({"phase": f"{tag}summary", "formulation": coder.formulation,
         "dat_bytes": dat_size, "needles": len(sizes),
         "deleted": len(deleted), "needles_on_victims": on_victims,
         "launches": launches, "rebuilt_sha256_equal": True,
         "decoded_equal": True, "sink_digests_equal": True})
    return launches, shard_sha


class env_set:
    """Set environment variables in this process for a block (None
    unsets one), and restore them after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class feed_recorder:
    """Record the feeds the pipeline opens during a block (the objects
    open_feed and ShardFeed return, whose class and O_DIRECT flags say
    what ran)."""

    def __enter__(self):
        self.feeds = []
        self.real = (feed.open_feed, feed.ShardFeed)

        def recorder(make):
            def recording(*args, **kwargs):
                f = make(*args, **kwargs)
                # mapped files, at open (close() drops the maps)
                mapped = (any(v is not None for v in f._views)
                          if hasattr(f, "_views")
                          else getattr(f, "_mm", None) is not None)
                self.feeds.append((f, mapped))
                return f
            return recording

        pipeline.feed_mod.open_feed = recorder(self.real[0])
        pipeline.feed_mod.ShardFeed = recorder(self.real[1])
        return self

    def __exit__(self, *exc):
        pipeline.feed_mod.open_feed, pipeline.feed_mod.ShardFeed = self.real

    def describe(self) -> list:
        out = []
        for f, mapped in self.feeds:
            readers = getattr(f, "_rds", None) or (
                [f._rd] if hasattr(f, "_rd") else [])
            out.append({"feed": type(f).__name__, "readers": f.readers,
                        "pinned": f.pool.pinned, "mapped": mapped,
                        "odirect_engaged": bool(readers) and all(
                            rd.direct for rd in readers)})
        return out


def shard_shas(base: str, g: geometry.Geometry) -> dict:
    return {i: sha256_file(base + geometry.to_ext(i))
            for i in range(g.total_shards)}


def last_stage_totals() -> dict:
    """The ec.* span totals (count, seconds) of the trace of the last
    wide event: the run that just ended."""
    trace = wideevents.events(svc="ec")[-1]["trace"]
    return {k: {"count": c, "seconds": us / 1e6} for k, (c, us) in
            sorted(observe.stage_totals(trace, prefix="ec.").items())}


def governed_encode(label: str, base: str, coder, g: geometry.Geometry,
                    want_sha: dict) -> dict:
    """One stream_encode(base, coder) with no batch size or depth; logs
    the planned operating point, the run's ec.* span totals, GB/s, the
    staging pool's allocation time and the feed, and checks the shards."""
    dat_size = os.path.getsize(base + ".dat")
    reg = metrics.shared("ec")
    # plan() is a pure function of the governor's state: this preview is
    # the point the run plans
    op = governor.get().plan(dat_size, g.data_shards)
    alloc0 = (reg.value("feed_pool_alloc_seconds"),
              reg.value("feed_pool_alloc_bytes"))
    with feed_recorder() as rec, \
            call_counter(pipeline, "host_row_digests") as host_sums:
        t0 = time.perf_counter()
        _, launches = counted(lambda: pipeline.stream_encode(base, coder, g))
        secs = time.perf_counter() - t0
    totals = last_stage_totals()
    same = shard_shas(base, g) == want_sha and host_sums.calls == 0
    row = {"phase": f"governed.{label}", "seconds": secs, "bytes": dat_size,
           "gbps": dat_size / secs / 1e9,
           "plan": {"batch_size": op.batch_size, "depth": op.depth,
                    "write_depth": op.write_depth, "readers": op.readers,
                    "formulation": op.formulation,
                    "steered_formulation": pipeline._steer_formulation(
                        coder, op).formulation,
                    "coder_formulation": coder.formulation},
           "stage_totals": totals,
           "pool_alloc_s": reg.value("feed_pool_alloc_seconds") - alloc0[0],
           "pool_alloc_bytes": reg.value("feed_pool_alloc_bytes")
           - alloc0[1],
           "feeds": rec.describe(), "launches": launches,
           "host_digest_calls": host_sums.calls,
           "sha256_equal_pinned": same}
    log(row)
    if not same:
        raise AssertionError(f"governed {label}: shards differ from the "
                             f"pinned run's, or the host summed digests")
    return row


def device_busy(fn, trace_path: Path) -> tuple:
    """(fn's result, the device's busy ledger over fn): fn runs under
    torch.profiler (CPU and CUDA activities); the exported Chrome trace's
    kernel and memcpy/memset events give the device's time, their union
    the busy time, and the host clock around fn the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in spans:
            spans[e["cat"]].append((float(e["ts"]),
                                    float(e["ts"]) + float(e["dur"])))
    intervals = sorted(iv for ivs in spans.values() for iv in ivs)
    busy, end = 0.0, None
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ledger = {"wall_s": wall,
              "kernel_s": sum(b - a for a, b in spans["kernel"]) / 1e6,
              "memcpy_s": sum(b - a for a, b in spans["gpu_memcpy"]) / 1e6,
              "kernels": len(spans["kernel"]),
              "memcpys": len(spans["gpu_memcpy"]),
              "busy_s": busy / 1e6}
    ledger["idle_share"] = (1 - ledger["busy_s"] / wall if intervals
                            else "not measured")
    return result, ledger


def run_governed(work: Path, coder, g: geometry.Geometry, volume: dict,
                 want_sha: dict, device: torch.device) -> dict:
    """The governed pipeline on copies of a source volume (phase 3d);
    returns the launches per step."""
    governor.reset()
    observe.reset()
    wideevents.reset()
    faults.clear()
    shutil.copytree(volume["dir"], work / "a")
    base = str(work / "a" / "1")
    launches = {}
    for i in range(3):
        launches[f"governed_encode_{i}"] = governed_encode(
            f"encode_{i}", base, coder, g, want_sha)["launches"]

    # a fourth governed run under torch.profiler: the device's busy and
    # idle share over an encode (the profiler's own cost included)
    (_, launches["governed_encode_profiled"]), ledger = device_busy(
        lambda: counted(lambda: pipeline.stream_encode(base, coder, g)),
        work / "trace.json")
    same = shard_shas(base, g) == want_sha
    log({"phase": "governed.encode_profiled", **ledger,
         "launches": launches["governed_encode_profiled"],
         "sha256_equal_pinned": same})
    if not same:
        raise AssertionError("profiled governed encode differs")

    # encode_many over two copies and a governed rebuild of the four
    # victims on each feed (the mmap feed's plain encodes ran above)
    (work / "b").mkdir()
    base_b = str(work / "b" / "1")
    shutil.copyfile(base + ".dat", base_b + ".dat")
    for tag, env in [("", {}), ("_preadv", {"WEED_EC_MMAP": "0"}),
                     ("_odirect", {"WEED_EC_ODIRECT": "1"})]:
        with env_set(**env):
            if tag:
                launches[f"governed_encode{tag}"] = governed_encode(
                    f"encode{tag}", base, coder, g, want_sha)["launches"]
            with feed_recorder() as rec:
                t0 = time.perf_counter()
                n, launches[f"governed_encode_many{tag}"] = counted(
                    lambda: pipeline.stream_encode_many([base, base_b],
                                                        coder, g))
                secs = time.perf_counter() - t0
            same = (n == 2 and shard_shas(base, g) == want_sha
                    and shard_shas(base_b, g) == want_sha)
            log({"phase": f"governed.encode_many{tag}", "volumes": n,
                 "seconds": secs,
                 "gbps": 2 * os.path.getsize(base + ".dat") / secs / 1e9,
                 "stage_totals": last_stage_totals(),
                 "feeds": rec.describe(),
                 "launches": launches[f"governed_encode_many{tag}"],
                 "sha256_equal_pinned": same})
            if not same:
                raise AssertionError(f"stream_encode_many{tag} shards "
                                     f"differ")
            for v in VICTIMS:
                os.remove(base + geometry.to_ext(v))
            with feed_recorder() as rec:
                rebuilt, launches[f"governed_rebuild{tag}"] = timed(
                    f"governed.stream_rebuild{tag}",
                    lambda: counted(
                        lambda: pipeline.stream_rebuild(base, coder, g)),
                    lambda r: os.path.getsize(base + geometry.to_ext(1))
                    * g.data_shards,
                    lambda r: {"launches": r[1],
                               "stage_totals": last_stage_totals(),
                               "feeds": rec.describe()})
            if rebuilt != list(VICTIMS) or shard_shas(base, g) != want_sha:
                raise AssertionError(f"governed rebuild{tag} of {rebuilt} "
                                     f"differs")
    shutil.rmtree(work / "b")

    # the fault drill, on the preadv feed (every read passes the hook)
    with env_set(WEED_EC_MMAP="0"):
        os.remove(base + ".ecm")
        faults.set_fault("ec.feed.read", "error")
        try:
            pipeline.stream_encode(base, coder, g)
        except faults.FaultError as e:
            raised = repr(e)
        else:
            raise AssertionError("armed ec.feed.read did not fail the run")
        finally:
            armed = faults.active()
            faults.clear()
        if os.path.exists(base + ".ecm"):
            raise AssertionError("a failed encode left a .ecm")
        pipeline.stream_encode(base, coder, g)
    same = os.path.exists(base + ".ecm") and shard_shas(base, g) == want_sha
    log({"phase": "governed.fault_drill", "raised": raised,
         "fired": armed[0]["fired"] if armed else 0,
         "no_ecm_after_fault": True, "after_clear_sha256_equal": same})
    if not same:
        raise AssertionError("encode after faults.clear() differs")

    # the tensor-core kernel's entry at the main path's batch shape
    rows, launches["mxu_entry"] = timed(
        "mxu_entry.parity_vs_shards",
        lambda: counted(lambda: check_parity_with(
            base, g, device,
            apply=lambda w, x: rs_cuda.gf_apply(w, x, repack="mxu"))),
        lambda r: r[0] * g.total_shards, lambda r: {"launches": r[1]})
    log({"phase": "governed.metrics",
         "ec_registry": metrics.render_shared().strip().splitlines()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 6: the Store EC lifecycle and the fused warm-down -----------

class StoreReader:
    """read_all's view of one volume id of a Store."""

    def __init__(self, store, vid: int):
        self.store, self.vid = store, vid

    def read_needle(self, nid: int, cookie=None):
        return self.store.read_needle(self.vid, nid, cookie=cookie)


# steps of phase 6 that run the coder (gf_apply must launch there); every
# other step launches no kernel at all
STORE_CODER_STEPS = ("store.ec_generate", "store.read_degraded",
                     "store.ec_rebuild", "fused.ec_fused_generate",
                     "fused.read_degraded")


def check_store_launches(launches: dict) -> None:
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in STORE_CODER_STEPS) != (counts["gf_apply"] > 0):
            raise AssertionError(f"{step}: launches {counts}")


def check_ecm_digests(base: str, g: geometry.Geometry, tag: str) -> None:
    stamped = pipeline.read_stamped_digests(base)
    files = pipeline.shard_file_digest(base, range(g.total_shards))
    if [stamped.get(i) for i in range(g.total_shards)] != files.tolist():
        raise AssertionError(f"{tag}: .ecm digests {stamped} != shard "
                             f"files {files.tolist()}")


def run_store_default(work: Path, device: torch.device,
                      total: int = 1 << 30,
                      min_on_victims: int = 200) -> dict:
    """(6a) The default collection, RS(10,4), through Store(coder_name=
    "auto"): write, ec_generate, reopen, reads, degraded reads,
    ec_blob_delete, ec_rebuild, ec_to_volume. Returns launches per step."""
    work.mkdir(parents=True)
    directory = str(work)
    base = os.path.join(directory, "1")
    seed = SEED + 6
    launches = {}
    # the governor's plan starts afresh, not from phase 3's retuning
    governor.reset()
    observe.reset()
    wideevents.reset()
    st = store_mod.Store([directory], coder_name="auto")
    g = st.geometry_for("")
    if (g.data_shards, g.parity_shards) != (10, 4):
        raise AssertionError(f"default collection geometry {g}")
    st.add_volume(1)
    sizes, deleted = timed(
        "store.write_volume",
        lambda: write_needles(lambda n: st.write_needle(1, n),
                              lambda n: st.delete_needle(1, n),
                              st.find_volume(1).data_file_size, total,
                              4 * MIB, seed),
        lambda r: st.find_volume(1).data_file_size(),
        lambda r: {"needles": len(r[0]), "deleted": len(r[1])})
    st.find_volume(1).sync()
    dat_size = os.path.getsize(base + ".dat")
    shutil.copyfile(base + ".dat", str(work / "source.dat"))
    with call_counter(pipeline, "host_row_digests") as host_sums:
        shard_ids, launches["store.ec_generate"] = timed(
            "store.ec_generate", lambda: counted(lambda: st.ec_generate(1)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
    if shard_ids != list(range(14)) or host_sums.calls:
        raise AssertionError(f"ec_generate gave {shard_ids}, "
                             f"{host_sums.calls} host digest sums")
    check_ecm_digests(base, g, "store.ec_generate")
    timed("store.parity_vs_plain",
          lambda: check_parity_with(base, g, device),
          lambda shard: shard * g.total_shards)
    shard_sha = shard_shas(base, g)
    # the shards take over: the volume goes, the reopened store finds
    # the EC volume through load_existing
    st.delete_volume(1)
    st.close()
    st = store_mod.Store([directory], coder_name="auto")
    try:
        ev = st.find_ec_volume(1)
        if ev is None or ev.shard_ids() != list(range(14)):
            raise AssertionError("reopened store: EC volume 1 has shards "
                                 f"{ev and ev.shard_ids()}")
        reader = StoreReader(st, 1)
        _, launches["store.read"] = timed(
            "store.read_all_shards",
            lambda: counted(lambda: read_all(reader, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1],
                       **latency_summary(r[0]["latencies"])})
        on_victims = needles_on(ev, sizes, deleted, VICTIMS)
        st.ec_delete_shards(1, "", list(VICTIMS))
        if ev.shard_ids() != [i for i in range(14) if i not in VICTIMS] \
                or any(os.path.exists(base + geometry.to_ext(v))
                       for v in VICTIMS):
            raise AssertionError("ec_delete_shards left shards")
        _, launches["store.read_degraded"] = timed(
            "store.read_degraded",
            lambda: counted(lambda: read_all(reader, sizes, deleted, seed)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], "needles_on_victims": on_victims,
                       **latency_summary(r[0]["latencies"])})
        if on_victims < min_on_victims:
            raise AssertionError(f"{on_victims} needles on the lost shards")
        live = sorted(n for n in sizes if n not in deleted)
        gone = set(live[:8])
        _, launches["store.ec_blob_delete"] = counted(
            lambda: [st.ec_blob_delete(1, nid) for nid in sorted(gone)])
        for nid in gone:
            try:
                st.read_needle(1, nid)
            except KeyError:
                continue
            raise AssertionError(f"blob-deleted needle {nid} readable")
        if os.path.getsize(base + ".ecj") != 8 * len(gone):
            raise AssertionError(".ecj does not journal the deletes")
        rebuilt, launches["store.ec_rebuild"] = timed(
            "store.ec_rebuild", lambda: counted(lambda: st.ec_rebuild(1)),
            lambda r: os.path.getsize(base + geometry.to_ext(1))
            * g.data_shards, lambda r: {"launches": r[1]})
        if rebuilt != list(VICTIMS) or any(
                sha256_file(base + geometry.to_ext(v)) != shard_sha[v]
                for v in VICTIMS):
            raise AssertionError(f"ec_rebuild of {rebuilt} differs")
        folded = all(st_types.size_is_deleted(ev.find_needle(nid)[1])
                     for nid in gone)
        if os.path.exists(base + ".ecj") or not folded:
            raise AssertionError(".ecj not folded into the .ecx")
        _, launches["store.ec_to_volume"] = timed(
            "store.ec_to_volume",
            lambda: counted(lambda: st.ec_to_volume(1)),
            lambda r: dat_size)
        decoded = os.path.getsize(base + ".dat")
        # the decoded .dat ends at the last live needle (FindDatFileSize):
        # the source's tail past it is the deletes' tombstone records
        with open(base + ".dat", "rb") as a, \
                open(str(work / "source.dat"), "rb") as b:
            while True:
                chunk = a.read(16 * MIB)
                if chunk != b.read(len(chunk)):
                    raise AssertionError("decoded .dat differs from the "
                                         "source")
                if not chunk:
                    break
        if st.find_volume(1) is None or st.find_ec_volume(1) is not None:
            raise AssertionError("ec_to_volume did not restore the volume")
        _, launches["store.read_restored"] = timed(
            "store.read_restored",
            lambda: counted(lambda: read_all(reader, sizes,
                                             deleted | gone, seed)),
            lambda r: r[0]["bytes"], lambda r: {"launches": r[1]})
    finally:
        st.close()
    check_store_launches(launches)
    log({"phase": "store.summary", "geometry": "RS(10,4)",
         "dat_bytes": dat_size, "decoded_dat_bytes": decoded,
         "needles": len(sizes), "deleted": len(deleted),
         "blob_deleted": len(gone), "needles_on_victims": on_victims,
         "reopen_found_shards": 14, "rebuilt_sha256_equal": True,
         "decoded_equal_source_prefix": True, "launches": launches})
    shutil.rmtree(work, ignore_errors=True)
    return launches


@functools.cache
def already_gzipped() -> bytes:
    return compression.compress(b"already " * 600)


def archive_needle(seed: int, nid: int) -> Needle:
    """The fused warm-down tests' five payload kinds
    (tests/test_fused_warmdown.py:95-126): compressible text, random
    bytes, tiny, already gzipped, bulky; names and mimes on every third."""
    rng = np.random.default_rng((seed, nid))
    kind = nid % 5
    if kind == 0:
        data = b"compressible text block " * int(rng.integers(1, 400))
    elif kind == 1:
        data = rng.bytes(int(rng.integers(1, 9000)))
    elif kind == 2:
        data = b"x" * int(rng.integers(1, 7))
    elif kind == 3:
        data = already_gzipped()
    else:
        data = b"padme" * int(rng.integers(100, 5000))
    n = Needle(cookie=nid * 7919 & 0xFFFFFFFF, id=nid, data=data)
    if kind == 3:
        n.set_flag(FLAG_IS_COMPRESSED)
    if nid % 3 == 0:
        n.name = f"file-{nid}.txt".encode()
        n.mime = b"text/plain"
        n.set_flag(FLAG_HAS_NAME)
        n.set_flag(FLAG_HAS_MIME)
    return n


def sequential_compact(volume, dst_dat: str, gzip_level: int = 1) -> int:
    """The chain the fused pass replaces, up to its .dat: per-needle reads
    of the live needles in offset order and the same gzip rule
    (tests/test_fused_warmdown.py:48-92). Returns the .dat size."""
    with volume._lock:
        snapshot = sorted((nv for nv in volume.nm.values()
                           if st_types.size_is_valid(nv.size)),
                          key=lambda nv: nv.offset)
        sb = SuperBlock(
            version=volume.super_block.version,
            replica_placement=volume.super_block.replica_placement,
            ttl=volume.super_block.ttl,
            compaction_revision=volume.super_block.compaction_revision + 1,
            extra=volume.super_block.extra)
    with open(dst_dat, "wb") as dat:
        dat.write(sb.to_bytes())
        offset = len(sb.to_bytes())
        for nv in snapshot:
            n = volume.read_needle_at(st_types.stored_to_offset(nv.offset),
                                      nv.size)
            if n.data and not n.is_compressed:
                head = n.data[:4096]
                trial = compression.compress(head, level=gzip_level)
                if len(trial) * 10 < len(head) * 9:
                    comp = compression.compress(n.data, level=gzip_level)
                    if len(comp) * 10 < len(n.data) * 9:
                        n.data = comp
                        n.set_flag(FLAG_IS_COMPRESSED)
            pad = (-offset) % st_types.NEEDLE_PADDING_SIZE
            dat.write(bytes(pad))
            record = n.to_bytes(volume.version)
            dat.write(record)
            offset += pad + len(record)
    return offset


# 6b reads every 8th needle (about 21000 of 168000 live ones, the first
# needle and each 8th after it): reading all took 135 s of the smoke
FUSED_READ_STRIDE = 8


def run_store_archive(work: Path, device: torch.device,
                      total: int = 1 << 30) -> dict:
    """(6b) The archive collection, RS(20,4), through the fused warm-down
    of Store(coder_name="auto"). Returns launches per step."""
    work.mkdir(parents=True)
    directory = str(work)
    base = os.path.join(directory, "archive_2")
    seed = SEED + 7
    launches = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    st = store_mod.Store([directory], coder_name="auto")
    try:
        g = st.geometry_for("archive")
        if (g.data_shards, g.parity_shards) != (20, 4):
            raise AssertionError(f"archive collection geometry {g}")
        vol = st.add_volume(2, collection="archive")

        def fill() -> tuple[int, set]:
            nid = 0
            while vol.data_file_size() < total:
                nid += 1
                st.write_needle(2, archive_needle(seed, nid))
            rng = np.random.default_rng(seed)
            # upstream's default vacuum garbageThreshold, 0.3
            gone = {int(i) + 1 for i in rng.choice(nid, size=int(0.3 * nid),
                                                   replace=False)}
            for d in sorted(gone):
                st.delete_needle(2, Needle(cookie=d * 7919 & 0xFFFFFFFF,
                                           id=d))
            return nid, gone

        count, deleted = timed(
            "fused.write_volume", fill, lambda r: vol.data_file_size(),
            lambda r: {"needles": r[0], "deleted": len(r[1])})
        src_bytes = vol.data_file_size()
        seq_size = timed(
            "fused.sequential_reference",
            lambda: sequential_compact(vol, str(work / "seq.dat")),
            lambda r: src_bytes)
        with call_counter(store_mod.ec_fused,
                          "fused_vacuum_gzip_encode") as rec:
            t0 = time.perf_counter()
            shard_ids, launches["fused.ec_fused_generate"] = counted(
                lambda: st.ec_fused_generate(2))
            secs = time.perf_counter() - t0
        stats = rec.results[0]
        marker = striping.read_marker_geometry(base)
        if shard_ids != list(range(24)) or marker != g:
            raise AssertionError(f"ec_fused_generate gave {shard_ids}, "
                                 f"marker {marker}")
        log({"phase": "fused.ec_fused_generate", "seconds": secs,
             "src_bytes": src_bytes, "gbps": src_bytes / secs / 1e9,
             **{k: stats[k] for k in (
                 "live_needles", "gzipped_needles", "gzip_s",
                 "gzip_workers", "compacted_bytes", "batch_size",
                 "readers", "commit_s")},
             "stage_totals": last_stage_totals(),
             "launches": launches["fused.ec_fused_generate"]})
        if stats["live_needles"] != count - len(deleted) or \
                not stats["gzipped_needles"]:
            raise AssertionError(f"fused stats {stats}")
        leftovers = [n for n in os.listdir(directory) if ".fusing" in n]
        if leftovers:
            raise AssertionError(f"staging files left: {leftovers}")
        check_ecm_digests(base, g, "fused")
        timed("fused.parity_vs_plain",
              lambda: check_parity_with(base, g, device),
              lambda shard: shard * g.total_shards)
        # decode a copy of the data shards: equal to the sequential chain
        (work / "decode").mkdir()
        dec = str(work / "decode" / "2")
        for i in range(g.data_shards):
            os.link(base + geometry.to_ext(i), dec + geometry.to_ext(i))
        with open(base + ".ecm") as f:
            dat_size = json.load(f)["dat_size"]
        striping.write_dat_file(dec, dat_size, g)
        if dat_size != seq_size or \
                sha256_file(dec + ".dat") != sha256_file(str(work /
                                                             "seq.dat")):
            raise AssertionError(f"fused .dat ({dat_size} bytes) differs "
                                 f"from the sequential chain's ({seq_size})")
        shutil.rmtree(work / "decode")
        # every live needle through an EcVolume with 4 shards lost
        ev = ec_volume.EcVolume(directory, "archive", 2, g,
                                coder=st.coder(g))

        def read_back() -> dict:
            nbytes, lat, on_victims = 0, [], 0
            for nid in range(1, count + 1, FUSED_READ_STRIDE):
                if nid in deleted:
                    try:
                        ev.read_needle(nid)
                    except KeyError:
                        continue
                    raise AssertionError(f"deleted needle {nid} readable")
                _, _, ivs = ev.locate(nid)
                on_victims += any(iv.to_shard_id_and_offset(g)[0]
                                  in VICTIMS for iv in ivs)
                t0 = time.perf_counter()
                n = ev.read_needle(nid, cookie=nid * 7919 & 0xFFFFFFFF)
                lat.append(time.perf_counter() - t0)
                want = archive_needle(seed, nid)
                got = (compression.decompress(n.data) if n.is_compressed
                       else n.data)
                if got != (compression.decompress(want.data)
                           if want.is_compressed else want.data):
                    raise AssertionError(f"needle {nid} reads back wrong")
                nbytes += len(got)
            return {"bytes": nbytes, "latencies": lat,
                    "on_victims": on_victims}

        try:
            for sid in range(g.total_shards):
                if sid not in VICTIMS:
                    ev.add_shard(sid)
            _, launches["fused.read_degraded"] = timed(
                "fused.read_degraded", lambda: counted(read_back),
                lambda r: r[0]["bytes"],
                lambda r: {"launches": r[1],
                           "needles_on_victims": r[0]["on_victims"],
                           **latency_summary(r[0]["latencies"])})
        finally:
            ev.close()
    finally:
        st.close()
    check_store_launches(launches)
    log({"phase": "fused.summary", "geometry": "RS(20,4)",
         "src_bytes": src_bytes, "compacted_bytes": dat_size,
         "needles": count, "deleted": len(deleted),
         "decoded_equal_sequential": True, "parity_equal_plain": True,
         "ecm_digests_equal_files": True, "launches": launches})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 7: the cluster through the port's servers -------------------

CLUSTER_COLLECTION = "ecsmoke"
# steps of phases 7 and 8 that run the coder (gf_apply must launch
# there); every other step launches no kernel at all
CLUSTER_CODER_STEPS = ("cluster.ec_encode", "cluster.read_one_shard_lost",
                       "cluster.read_server_lost", "cluster.ec_rebuild",
                       "replicated.ec_encode",
                       "replicated.read_server_lost",
                       "replicated.ec_rebuild")


def upload_needles(client, vid: int, size_now, total: int,
                   max_needle: int, seed: int, collection: str,
                   replication: str = "",
                   delete_share: int = 20) -> tuple[dict, set]:
    """write_needles over HTTP: each needle assigned by the master and
    POSTed to the volume server (which fans it out to the volume's other
    holders); then one in `delete_share` deleted with HTTP DELETE, none
    when it is 0. Returns fid -> (payload seed id, size), and the
    deleted fids."""
    rng = np.random.default_rng(seed)
    fids: dict = {}
    nid = 0
    while size_now() < total:
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - size_now())
        a = client.assign(collection=collection, replication=replication)
        if int(a["fid"].split(",")[0]) != vid:
            raise AssertionError(f"assigned {a['fid']}, not volume {vid}")
        client.upload_blob(a["url"], a["fid"], payload(seed, nid, size))
        fids[a["fid"]] = (nid, size)
    deleted: set = set()
    if delete_share:
        deleted = {str(fid) for fid in rng.choice(
            sorted(fids), size=max(1, len(fids) // delete_share),
            replace=False)}
    for fid in sorted(deleted):
        client.delete(fid)
    return fids, deleted


def http_read_all(client, fids: dict, deleted: set, seed: int,
                  url: str = "") -> dict:
    """Every live needle read back over HTTP byte-identical (from the
    holder `url`, or the holder from the master's lookup), every deleted
    one refused with 404; returns the bytes read and each live read's
    latency."""
    client._vid_cache.clear()
    nbytes, lat = 0, []
    for fid, (nid, size) in fids.items():
        if fid in deleted:
            try:
                client.download(fid, url=url)
            except ClientError as e:
                if "HTTP 404" not in str(e):
                    raise
                continue
            raise AssertionError(f"deleted needle {fid} still readable")
        t0 = time.perf_counter()
        data = client.download(fid, url=url)
        lat.append(time.perf_counter() - t0)
        if data != payload(seed, nid, size):
            raise AssertionError(f"needle {fid} reads back wrong")
        nbytes += size
    return {"bytes": nbytes, "latencies": lat}


def needles_on_shards(ev, fids: dict, deleted: set, shards) -> int:
    return needles_on(ev, {FileId.parse(f).key: 0 for f in fids},
                      {FileId.parse(f).key for f in deleted}, tuple(shards))


def wait_until(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def check_cluster_launches(launches: dict) -> None:
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in CLUSTER_CODER_STEPS) != (counts["gf_apply"]
                                                       > 0):
            raise AssertionError(f"{step}: launches {counts}")


def run_cluster(work: Path, device: torch.device, total: int = 1 << 30,
                pulse: float = 0.5) -> dict:
    """(7a) A master and 3 volume servers in this process
    (``Store(coder_name="auto")`` each) on loopback ports; the client,
    the shell's EcCommands and every server-to-server call go over HTTP.
    Returns launches per step."""
    work.mkdir(parents=True)
    seed = SEED + 8
    col = CLUSTER_COLLECTION
    launches = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    # the shell's rebuild and fix, not the repair daemon, heal phases 7
    # and 8 (the daemon would race them and change what they measure)
    cl = LocalCluster(3, coder_name="auto", volume_size_limit_mb=1024,
                      pulse=pulse, directory=str(work), racks=1,
                      master_kwargs={"repair_enabled": False})
    try:
        client = Client(cl.master_url)
        grown = client.grow(count=1, collection=col)
        if grown.get("count") != 1:
            raise AssertionError(f"/vol/grow: {grown}")
        vid = grown["volume_ids"][0]
        src = cl.index_of(client.lookup(vid)[0])
        vol = cl.store(src).find_volume(vid)
        fids, deleted = timed(
            "cluster.upload",
            lambda: upload_needles(client, vid, vol.data_file_size, total,
                                   4 * MIB, seed, col),
            lambda r: vol.data_file_size(),
            lambda r: {"needles": len(r[0]), "deleted": len(r[1]),
                       "volume_id": vid})
        # the sealed .dat, copied before the encode
        client.volume_admin(cl.url(src), "volume/readonly",
                            {"volume_id": vid, "read_only": True})
        vol.sync()
        dat_size = vol.data_file_size()
        sealed = str(work / "sealed.dat")
        shutil.copyfile(vol.base_file_name() + ".dat", sealed)
        shell = EcCommands(client)
        result, launches["cluster.ec_encode"] = timed(
            "cluster.ec_encode", lambda: counted(
                lambda: shell.encode(vid, col)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
        info = client.ec_lookup(vid)
        holders: dict = {}
        for sid, urls in info["shards"].items():
            for u in urls:
                holders.setdefault(u, []).append(int(sid))
        spread = sorted(len(s) for s in holders.values())
        if len(info["shards"]) != 14 or spread != [4, 5, 5]:
            raise AssertionError(f"shards {info['shards']}")
        if any(cl.store(i).find_volume(vid) is not None for i in range(3)):
            raise AssertionError("the original volume is still mounted")
        # the shards gathered from the three directories: the parity
        # equals the plain version's over the data shards, and the data
        # shards decode to the sealed copy
        g = geometry.DEFAULT
        gather = work / "gather"
        gather.mkdir()
        base = str(gather / f"{col}_{vid}")
        for url, sids in holders.items():
            node_base = os.path.join(cl.nodes[cl.index_of(url)][3],
                                     f"{col}_{vid}")
            for sid in sids:
                os.symlink(node_base + geometry.to_ext(sid),
                           base + geometry.to_ext(sid))
        timed("cluster.parity_vs_plain",
              lambda: check_parity_with(base, g, device),
              lambda shard: shard * g.total_shards)
        striping.write_dat_file(base, dat_size, g)
        if sha256_file(base + ".dat") != sha256_file(sealed):
            raise AssertionError("the data shards do not decode to the "
                                 "sealed .dat")
        orig_sha = shard_shas(base, g)
        shutil.rmtree(gather)
        os.remove(sealed)
        log({"phase": "cluster.spread", "shards_per_server": spread,
             "parity_equal_plain": True, "data_equal_sealed": True,
             "volume_retired": True})

        def read_step(name: str, **extra):
            _, launches[name] = timed(
                name, lambda: counted(
                    lambda: http_read_all(client, fids, deleted, seed)),
                lambda r: r[0]["bytes"],
                lambda r: {"launches": r[1], **extra,
                           **latency_summary(r[0]["latencies"])})

        read_step("cluster.read_all_shards")
        # one data shard of the server with 4 goes (the SURVEY section 7
        # exit test), then that server: 4 shards lost in all
        lost_url = next(u for u, s in holders.items() if len(s) == 4)
        lost = cl.index_of(lost_url)
        victim = min(holders[lost_url])
        reader = cl.index_of(client.lookup(vid)[0])
        on_victim = needles_on_shards(cl.store(reader).find_ec_volume(vid),
                                      fids, deleted, [victim])
        client.volume_admin(lost_url, "ec/delete_shards",
                            {"volume_id": vid, "collection": col,
                             "shard_ids": [victim]})
        read_step("cluster.read_one_shard_lost", lost_shard=victim,
                  needles_on_lost=on_victim)
        on_lost = needles_on_shards(cl.store(reader).find_ec_volume(vid),
                                    fids, deleted, holders[lost_url])
        cl.stop_volume_server(lost)
        wait_until(lambda: lost_url not in {
            u for us in client.ec_lookup(vid)["shards"].values()
            for u in us}, "the master to prune the stopped server")
        read_step("cluster.read_server_lost", lost_shards=holders[lost_url],
                  needles_on_lost=on_lost)
        if on_victim < 20 or on_lost < 200:
            raise AssertionError(f"{on_victim} / {on_lost} needles on the "
                                 "lost shards")
        rb, launches["cluster.ec_rebuild"] = timed(
            "cluster.ec_rebuild", lambda: counted(
                lambda: shell.rebuild(vid, col)),
            lambda r: shard_size_of(r[0], cl, col, vid) * g.data_shards,
            lambda r: {"launches": r[1], "rebuilder": r[0]["rebuilder"],
                       "rebuilt": r[0]["rebuilt"]})
        if sorted(rb["rebuilt"]) != sorted(holders[lost_url]):
            raise AssertionError(f"rebuilt {rb['rebuilt']}")
        rb_dir = cl.nodes[cl.index_of(rb["rebuilder"])][3]
        for sid in rb["rebuilt"]:
            got = sha256_file(os.path.join(rb_dir, f"{col}_{vid}")
                              + geometry.to_ext(sid))
            if got != orig_sha[sid]:
                raise AssertionError(f"rebuilt shard {sid} differs")
        if len(client.ec_lookup(vid)["shards"]) != 14:
            raise AssertionError("14 shards not mounted after ec.rebuild")
        _, launches["cluster.ec_decode"] = timed(
            "cluster.ec_decode", lambda: counted(
                lambda: shell.decode(vid, col)),
            lambda r: dat_size, lambda r: {"launches": r[1]})
        if client.ec_lookup(vid).get("shards"):
            raise AssertionError("shards left after ec.decode")
        read_step("cluster.read_decoded")
        log({"phase": "cluster.summary", "servers": 3,
             "geometry": "RS(10,4)", "volume_size_limit_mb": 1024,
             "dat_bytes": dat_size, "needles": len(fids),
             "deleted": len(deleted), "shards_per_server": spread,
             "lost_shard": victim, "lost_server_shards": holders[lost_url],
             "rebuilt_sha256_equal": True, "decoded_reads_back": True,
             "launches": dict(launches)})
        # phase 8 in the same cluster
        launches.update(run_replicated(cl, client,
                                       min(total, REPL_VOLUME_BYTES),
                                       seed + 100))
    finally:
        cl.shutdown()
    check_cluster_launches(launches)
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 8: the hot tier: replication, vacuum, repair, then EC --------

REPL_COLLECTION = "repsmoke"
# upstream's "one more copy on the same rack"
REPL_PLACEMENT = "001"
# upstream's default -garbageThreshold
GARBAGE_THRESHOLD = 0.3
# uploads that run while the vacuum compacts (the makeup-diff replay)
MAKEUP_UPLOADS = 64


def fresh_lookup(client, vid: int) -> list:
    client._vid_cache.clear()
    return client.lookup(vid)


def holder_volume(cl, url: str, vid: int):
    return cl.store(cl.index_of(url)).find_volume(vid)


def holders_of(info: dict) -> dict:
    """url -> shard ids, from a /col/lookup/ec answer."""
    out: dict = {}
    for sid, urls in info["shards"].items():
        for u in urls:
            out.setdefault(u, []).append(int(sid))
    return out


def garbage_level(url: str, vid: int) -> float:
    status, body = http.get_json(
        f"http://{url}/admin/vacuum/check?volume_id={vid}")
    if status != 200:
        raise AssertionError(f"vacuum check on {url}: {body}")
    return body["garbage_level"]


def run_replicated(cl, client, total: int, seed: int) -> dict:
    """(8) In phase 7's cluster, on one rack: a volume of `total` bytes of
    collection repsmoke at replication 001 filled over HTTP (every 201
    means both copies are written) and read back from each holder,
    needles deleted until both holders' garbage is at least 0.3,
    /vol/vacuum with 64 uploads running against the volume, every live
    needle read from each holder, one holder
    replaced by a fresh server and restored with volume.fix.replication,
    every needle read from the new copy, then ec.encode (both copies
    retired, shards spread 5/5/4), reads with the 4-shard server lost and
    ec.rebuild. Returns launches per step."""
    col = REPL_COLLECTION
    launches = {}
    for _ in range(3 - cl.node_count()):
        # phase 7 lost a server: a fresh one takes its place
        cl.add_volume_server()
    cl.wait_for_nodes(3)
    grown = client.grow(count=1, collection=col, replication=REPL_PLACEMENT)
    if grown.get("count") != 1:
        raise AssertionError(f"/vol/grow replication 001: {grown}")
    vid = grown["volume_ids"][0]
    primary, replica = client.lookup(vid)
    # fids for the uploads that run during the vacuum, assigned while
    # the volume is writable (the vacuum parks it out of assignment)
    late = [client.assign(collection=col, replication=REPL_PLACEMENT)
            for _ in range(MAKEUP_UPLOADS)]
    if any(int(a["fid"].split(",")[0]) != vid for a in late):
        raise AssertionError("late fids on another volume")
    vol = holder_volume(cl, primary, vid)
    (fids, _), launches["replicated.upload"] = timed(
        "replicated.upload", lambda: counted(lambda: upload_needles(
            client, vid, vol.data_file_size, total, 4 * MIB, seed, col,
            replication=REPL_PLACEMENT, delete_share=0)),
        lambda r: vol.data_file_size(),
        lambda r: {"needles": len(r[0][0]), "volume_id": vid,
                   "replication": REPL_PLACEMENT, "launches": r[1]})
    for url in (primary, replica):
        held = holder_volume(cl, url, vid).file_count()
        if held != len(fids):
            raise AssertionError(f"{url} holds {held} of {len(fids)} "
                                 "needles")
    deleted: set = set()

    def read_step(name: str, url: str = "", **extra):
        _, launches[name] = timed(
            name, lambda: counted(lambda: http_read_all(
                client, fids, deleted, seed, url=url)),
            lambda r: r[0]["bytes"],
            lambda r: {"launches": r[1], **extra,
                       **latency_summary(r[0]["latencies"])})

    # every acknowledged write, from each holder, before the vacuum
    read_step("replicated.read_primary_pre", primary, holder="primary")
    read_step("replicated.read_replica_pre", replica, holder="replica")

    def delete_to_threshold() -> set:
        order = list(np.random.default_rng(seed).permutation(sorted(fids)))
        gone: set = set()
        while min(garbage_level(u, vid) for u in (primary, replica)) \
                < GARBAGE_THRESHOLD:
            if len(gone) == len(order):
                raise AssertionError("every needle deleted, garbage under "
                                     f"{GARBAGE_THRESHOLD}")
            for fid in order[len(gone):len(gone) + 20]:
                client.delete(fid)
                gone.add(fid)
        return gone

    deleted, launches["replicated.delete"] = timed(
        "replicated.delete", lambda: counted(delete_to_threshold), None,
        lambda r: {"deleted": len(r[0]), "launches": r[1],
                   "garbage_levels": [garbage_level(u, vid)
                                      for u in (primary, replica)]})
    before = {u: (holder_volume(cl, u, vid).data_file_size(),
                  holder_volume(cl, u, vid).deleted_size())
              for u in (primary, replica)}
    rng = np.random.default_rng(seed + 1)
    late_fids = {}
    for j, a in enumerate(late):
        size = int(np.exp(rng.uniform(np.log(1024), np.log(4 * MIB))))
        late_fids[a["fid"]] = (10 ** 6 + j, size)
    spans: list = []

    def vacuum_with_uploads() -> dict:
        box: dict = {}

        def run() -> None:
            t0 = time.perf_counter()
            box["result"] = client.vacuum(GARBAGE_THRESHOLD)
            box["span"] = (t0, time.perf_counter())

        th = threading.Thread(target=run, name="smoke-vacuum")
        th.start()
        try:
            for a in late:
                nid, size = late_fids[a["fid"]]
                t0 = time.perf_counter()
                client.upload_blob(a["url"], a["fid"],
                                   payload(seed, nid, size))
                spans.append((t0, time.perf_counter()))
        finally:
            th.join()
        return box

    # GB/s of the vacuum: over both holders' .dat bytes before it
    box, launches["replicated.vacuum"] = timed(
        "replicated.vacuum", lambda: counted(vacuum_with_uploads),
        lambda r: sum(size for size, _ in before.values()),
        lambda r: {"compacted": r[0]["result"]["compacted"],
                   "launches": r[1]})
    if vid not in box["result"]["compacted"]:
        raise AssertionError(f"/vol/vacuum compacted "
                             f"{box['result']['compacted']}, not {vid}")
    v0, v1 = box["span"]
    overlapped = sum(1 for a, b in spans if b > v0 and a < v1)
    fids.update(late_fids)
    reclaimed = {}
    for url in (primary, replica):
        v = holder_volume(cl, url, vid)
        if v.super_block.compaction_revision != 1:
            raise AssertionError(f"{url}: volume {vid} not compacted")
        sizes = dict(v.nm.live_entries())
        added = sum(st_types.get_actual_size(
            sizes[FileId.parse(f).key], v.version) for f in late_fids)
        size_before, deleted_before = before[url]
        reclaimed[url] = size_before + added - v.data_file_size()
        if reclaimed[url] < deleted_before:
            raise AssertionError(f"{url} reclaimed {reclaimed[url]} of "
                                 f"{deleted_before} deleted bytes")
        if v.file_count() != len(fids) - len(deleted):
            raise AssertionError(f"{url} holds {v.file_count()} needles "
                                 "after the vacuum")
    log({"phase": "replicated.reclaimed",
         "reclaimed_bytes": list(reclaimed.values()),
         "deleted_bytes": [before[u][1] for u in (primary, replica)],
         "dat_bytes_before": [before[u][0] for u in (primary, replica)],
         "dat_bytes_after": [holder_volume(cl, u, vid).data_file_size()
                             for u in (primary, replica)],
         "uploads_during_vacuum": overlapped})
    if not overlapped:
        raise AssertionError("no upload overlapped the vacuum")

    read_step("replicated.read_primary", primary, holder="primary")
    read_step("replicated.read_replica", replica, holder="replica")
    # the replica's server is lost; a fresh one, with an empty
    # directory, takes its place
    cl.stop_volume_server(cl.index_of(replica))
    fresh = cl.add_volume_server()
    wait_until(lambda: fresh_lookup(client, vid) == [primary]
               and cl.node_count() == 3,
               "the master to prune the lost holder")
    shell_commands._register_all()
    env = shell_commands.CommandEnv(client)
    out, launches["replicated.fix_replication"] = timed(
        "replicated.fix_replication", lambda: counted(
            lambda: shell_commands.run_command(
                env, ["volume.fix.replication", "-force"])),
        lambda r: holder_volume(cl, primary, vid).data_file_size(),
        lambda r: {"plan": r[0]["plan"], "launches": r[1],
                   "fresh_server": fresh})
    added = [a for a in out["plan"] if a["volume_id"] == vid]
    if [a["action"] for a in added] != ["add"] or sorted(
            fresh_lookup(client, vid)) != sorted([primary, added[0]["to"]]):
        raise AssertionError(f"volume.fix.replication: {out}")
    new_copy = added[0]["to"]
    read_step("replicated.read_new_copy", new_copy,
              holder="volume.fix.replication's copy")
    shell = EcCommands(client)
    dat_size = holder_volume(cl, primary, vid).data_file_size()
    _, launches["replicated.ec_encode"] = timed(
        "replicated.ec_encode", lambda: counted(
            lambda: shell.encode(vid, col)),
        lambda r: dat_size, lambda r: {"launches": r[1]})
    holders = holders_of(client.ec_lookup(vid))
    spread = sorted(len(s) for s in holders.values())
    if spread != [4, 5, 5] or any(
            n[2] is not None and n[2].find_volume(vid) is not None
            for n in cl.nodes):
        raise AssertionError(f"ec.encode left {holders} and the copies")
    lost_url = next(u for u, s in holders.items() if len(s) == 4)
    cl.stop_volume_server(cl.index_of(lost_url))
    wait_until(lambda: lost_url not in holders_of(client.ec_lookup(vid)),
               "the master to prune the 4-shard server")
    read_step("replicated.read_server_lost", lost_shards=holders[lost_url])
    rb, launches["replicated.ec_rebuild"] = timed(
        "replicated.ec_rebuild", lambda: counted(
            lambda: shell.rebuild(vid, col)),
        lambda r: shard_size_of(r[0], cl, col, vid)
        * geometry.DEFAULT.data_shards,
        lambda r: {"launches": r[1], "rebuilt": r[0]["rebuilt"]})
    if sorted(rb["rebuilt"]) != holders[lost_url] or \
            len(client.ec_lookup(vid)["shards"]) != 14:
        raise AssertionError(f"ec.rebuild: {rb}")
    log({"phase": "replicated.summary", "replication": REPL_PLACEMENT,
         "volume_id": vid, "needles": len(fids), "deleted": len(deleted),
         "late_uploads": MAKEUP_UPLOADS, "uploads_during_vacuum": overlapped,
         "reclaimed_bytes": list(reclaimed.values()),
         "shards_per_server": spread, "launches": launches})
    return launches


# --- phase 9: the self-driving warm tier ---------------------------------

LC_COLLECTION = "lcsmoke"
LC_REP = "lcrep"
LC_TMP = "lctmp"
# the lifecycle rules of phase 9 (LifecycleConfig)
LC_WARM_AFTER = 10.0
LC_INTERVAL = 0.5
LC_TTL, LC_TTL_GRACE = 3.0, 1.0
# decayed read rate (reads/s) at which a warm volume decodes back: above
# what steps 2-4 drive (every needle read in turn, mean needle 0.5 MB:
# 106-269 reads/s on the card's hosts) and below what step 7's 8 threads
# drive on 256 small needles read from their shards' holders
LC_HOT_READ_RATE = 400.0
# steps 4 and 7 read a fixed sample: the first needle of each volume
# (in upload order) and each LC_SAMPLE-th after it
LC_SAMPLE = 4
# the volume servers' heat half-life (WEED_LIFECYCLE_HEAT_HALFLIFE, s)
LC_HALFLIFE = "2"
# the longest step 7's reads may take to turn the volume hot
LC_HOT_TIMEOUT = 300.0
# steps of phase 9 that run the coder (gf_apply must launch there, and in
# no other step of the phase)
LIFECYCLE_CODER_STEPS = ("lifecycle.warm_down", "lifecycle.bit_rot",
                         "lifecycle.holder_death")
# launches counted beside the steps': the direct warm-down of the
# snapshot (a check), and the degraded reads inside step 4; both must
# run the coder, and neither adds to the main path's count
LIFECYCLE_CHECKS = ("lifecycle.warm_down_check", "lifecycle.read_degraded")
SMI = [""]


def lc_log(step: str, secs: float, nbytes: int = 0, lat=None,
           launches=None, **extra) -> None:
    """One phase-9 line: wall s, GB/s where bytes moved, read p50/p99,
    launches, and the card beside them."""
    row = {"phase": step, "seconds": secs}
    if nbytes:
        row.update(bytes=nbytes, gbps=nbytes / secs / 1e9)
    if lat:
        row.update(latency_summary(lat))
    if launches is not None:
        row["launches"] = launches
    row.update(extra)
    row["card"] = SMI[0]
    log(row)


def fill_pair(client, url: str, vols: dict, total: int, max_needle: int,
              seed: int) -> tuple[dict, dict]:
    """Phase 3's generator over HTTP into two volumes of one server at
    once, each needle to the emptier volume (the master mints its key and
    cookie), until both hold `total` bytes; then one needle in 20 of each
    deleted. Returns vid -> {fid: (nid, size)} and vid -> deleted fids."""
    rng = np.random.default_rng(seed)
    fids: dict = {vid: {} for vid in vols}
    nid = 0
    while True:
        open_vids = [v for v, vol in vols.items()
                     if vol.data_file_size() < total]
        if not open_vids:
            break
        vid = min(open_vids, key=lambda v: vols[v].data_file_size())
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(max_needle))))
        size = min(size, total - vols[vid].data_file_size())
        minted = FileId.parse(client.assign(collection=LC_COLLECTION)["fid"])
        fid = str(FileId(vid, minted.key, minted.cookie))
        client.upload_blob(url, fid, payload(seed, nid, size))
        fids[vid][fid] = (nid, size)
    deleted = {}
    for vid, f in fids.items():
        deleted[vid] = {str(x) for x in rng.choice(
            sorted(f), size=max(1, len(f) // 20), replace=False)}
        for fid in sorted(deleted[vid]):
            client.delete(fid)
    return fids, deleted


def lc_read(client, step: str, fids: dict, deleted: set, seed: int,
            vid: int, launches: dict, url: str = "",
            stride: int = 1) -> dict:
    """Every needle of one volume over HTTP (or the first and each
    `stride`-th after it, in upload order), counted launches, with the
    master's decayed read rate for the volume after it."""
    fids = {f: v for i, (f, v) in enumerate(fids.items())
            if i % stride == 0}
    t0 = time.perf_counter()
    out, launches[step] = counted(
        lambda: http_read_all(client, fids, deleted, seed, url=url))
    heat = client.volume_heat(vid)["volumes"]
    lc_log(step, time.perf_counter() - t0, out["bytes"], out["latencies"],
           launches[step], volume_id=vid,
           reads_per_s=len(out["latencies"]) / (time.perf_counter() - t0),
           heat_read_rate=heat[0]["read_rate"] if heat else None,
           sampled_every=stride)
    return out


def ec_holders(client, vid: int) -> dict:
    """url -> sorted shard ids of an EC volume ({} when it has none)."""
    info = client.ec_lookup(vid)
    if not info.get("shards"):
        return {}
    return {u: sorted(s) for u, s in holders_of(info).items()}


def holds_normal(cl, vid: int) -> bool:
    return any(n[2] is not None and n[2].find_volume(vid) is not None
               for n in cl.nodes)


def warm_outcomes(client) -> list:
    return [(e["kind"], e["volume"], e["outcome"])
            for e in client.lifecycle_status()["recent"]]


def mounted_on(url: str) -> int:
    return sum(len(s["shard_ids"])
               for s in http.get_json(f"http://{url}/status")[1]
               ["ec_shards"])


def scrub(cl, client, url: str) -> tuple[dict, float]:
    """One scrub pass on `url`: its answer and the shards it checked."""
    vs = cl.nodes[cl.index_of(url)][0]
    before = vs.metrics.value("scrub_shards_checked")
    out = client.volume_admin(url, "ec/scrub", {"throttle_seconds": 0})
    return out, vs.metrics.value("scrub_shards_checked") - before


def shard_file(cl, url: str, col: str, vid: int, sid: int) -> str:
    return os.path.join(cl.nodes[cl.index_of(url)][3],
                        f"{col}_{vid}") + geometry.to_ext(sid)


def run_lifecycle(work: Path, total: int = 1 << 30,
                  small: int = 64 * MIB, max_needle: int = 4 * MIB,
                  limit_mb: int = 1024, pulse: float = 0.5,
                  hot_rate: float = LC_HOT_READ_RATE,
                  coder_name: str = "auto", device=None,
                  hot_threads: int = 8) -> dict:
    """(9) The self-driving warm tier, in its own cluster: a master with
    the lifecycle rules and the repair daemon, and 4 volume servers on
    one rack (``Store(coder_name="auto")`` each, the scrub loop off). No
    operator command from step 2 on: two full idle volumes warm down in
    one fused window, bit rot and a dead holder heal, a lost replica
    comes back, a TTL volume expires, a hot volume decodes back. Returns
    launches per step; those of ``LIFECYCLE_CHECKS`` are also counted in
    a step's or are a check's own."""
    work.mkdir(parents=True)
    seed = SEED + 9
    col = LC_COLLECTION
    launches: dict = {}
    governor.reset()
    observe.reset()
    wideevents.reset()
    cfg = LifecycleConfig(warm_after=LC_WARM_AFTER, interval=LC_INTERVAL,
                          hot_read_rate=hot_rate,
                          collection_ttls={LC_TMP: LC_TTL},
                          ttl_grace=LC_TTL_GRACE)
    with env_set(WEED_LIFECYCLE_HEAT_HALFLIFE=LC_HALFLIFE):
        cl = LocalCluster(
            4, coder_name=coder_name, device=device,
            volume_size_limit_mb=limit_mb, pulse=pulse,
            directory=str(work / "cluster"), racks=1,
            master_kwargs={"lifecycle_config": cfg,
                           "maintenance_interval_seconds": pulse},
            volume_kwargs={"scrub_interval_seconds": 0})
    try:
        client = Client(cl.master_url)
        m = cl.master.metrics
        # 1. two volumes of lcsmoke on one server, filled at once
        src = cl.url(0)
        vids = [1, 2]
        for vid in vids:
            client.volume_admin(src, "assign_volume",
                                {"volume_id": vid, "collection": col})
        vols = {vid: cl.store(0).find_volume(vid) for vid in vids}
        t0 = time.perf_counter()
        (fids, deleted), launches["lifecycle.fill"] = counted(
            lambda: fill_pair(client, src, vols, total, max_needle, seed))
        src_bytes = sum(v.data_file_size() for v in vols.values())
        lc_log("lifecycle.fill", time.perf_counter() - t0, src_bytes,
               launches=launches["lifecycle.fill"],
               volumes=vids, needles=[len(fids[v]) for v in vids],
               deleted=[len(deleted[v]) for v in vids])
        # the last access of both at one instant, so that both turn idle
        # in one pass: the smallest live needle of each, read
        for vid in vids:
            live = [f for f in fids[vid] if f not in deleted[vid]]
            client.download(min(live, key=lambda f: fids[vid][f][1]))
        t_touch = time.monotonic()
        snap = work / "snapshot"
        snap.mkdir()
        vols[vids[0]].sync()
        base0 = vols[vids[0]].base_file_name()
        for ext in (".dat", ".idx"):
            shutil.copyfile(base0 + ext, snap / f"{col}_{vids[0]}{ext}")
        copied_s = time.monotonic() - t_touch
        if copied_s >= LC_WARM_AFTER or any(v.read_only
                                            for v in vols.values()):
            raise AssertionError(f"the snapshot took {copied_s} s")

        # 2. warm-down with no command: seal, one fused window of both,
        # spread 4/4/3/3, 14/14 verified, the originals retired
        def warmed() -> bool:
            return all(len(client.ec_lookup(v).get("shards", {})) == 14
                       and not holds_normal(cl, v) for v in vids)

        def wait_warm():
            wait_until(warmed, "the daemon's warm-down", timeout=900)
            wait_until(lambda: sorted(o for o in warm_outcomes(client)
                                      if o[0] == "warm")
                       == [("warm", v, "ok") for v in vids],
                       "the warm transitions' outcomes")

        _, launches["lifecycle.warm_down"] = counted(wait_warm)
        t_warm = time.monotonic()
        windows = {k: m.value("lifecycle_encode_windows",
                              {"volumes": str(k)}) for k in (1, 2)}
        if windows != {1: 0, 2: 1}:
            raise AssertionError(f"encode windows {windows}, want one "
                                 "of two volumes")
        spreads = {v: sorted(map(len, ec_holders(client, v).values()))
                   for v in vids}
        if any(s != [3, 3, 4, 4] for s in spreads.values()):
            raise AssertionError(f"spreads {spreads}")
        lc_log("lifecycle.warm_down", t_warm - t_touch, src_bytes,
               launches=launches["lifecycle.warm_down"],
               trigger_to_action_s=t_warm - t_touch - LC_WARM_AFTER,
               windows_of_two=windows[2], shards_per_server=spreads[1],
               snapshot_copy_s=copied_s)
        # the direct warm-down of the snapshot: the same 14 shards
        st = store_mod.Store([str(snap)], coder_name=coder_name,
                             device=device)
        try:
            t0 = time.perf_counter()
            _, launches["lifecycle.warm_down_check"] = counted(
                lambda: st.ec_fused_generate(vids[0]))
            check_s = time.perf_counter() - t0
        finally:
            st.close()
        holders0 = ec_holders(client, vids[0])
        for url, sids in holders0.items():
            for sid in sids:
                want = sha256_file(str(snap / f"{col}_{vids[0]}")
                                   + geometry.to_ext(sid))
                if sha256_file(shard_file(cl, url, col, vids[0],
                                          sid)) != want:
                    raise AssertionError(f"shard {sid} differs from "
                                         "ec_fused_generate's")
        shutil.rmtree(snap)
        log({"phase": "lifecycle.warm_down_check", "seconds": check_s,
             "shards_sha256_equal": 14,
             "launches": launches["lifecycle.warm_down_check"],
             "card": SMI[0]})
        for vid in vids:
            lc_read(client, f"lifecycle.read_warm_{vid}", fids[vid],
                    deleted[vid], seed, vid, launches)
        states = {v["volume"]: v["state"]
                  for v in client.volume_heat()["volumes"]}
        if [states.get(v) for v in vids] != ["warm", "warm"]:
            raise AssertionError(f"volume.heat states {states}")

        # 3. bit rot: one byte of a shard flipped, found by the scrub,
        # dropped and rebuilt by the repair daemon
        a, b = vids
        url, sids = max(sorted(ec_holders(client, a).items()),
                        key=lambda kv: len(kv[1]))
        sid = sids[-1]
        path = shard_file(cl, url, col, a, sid)
        want = sha256_file(path)
        ok0 = m.value("repairs_succeeded", {"kind": "ec"})
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        t_flip = time.monotonic()

        def heal_rot():
            out, checked = scrub(cl, client, url)
            if out["bad"] != {str(a): [sid]} or \
                    checked != mounted_on(url):
                raise AssertionError(f"scrub of {url}: {out}, checked "
                                     f"{checked} of {mounted_on(url)}")
            wait_until(lambda: m.value("repairs_succeeded",
                                       {"kind": "ec"}) > ok0
                       and len(client.ec_lookup(a)["shards"]) == 14,
                       "the rotten shard dropped and rebuilt",
                       timeout=600)

        _, launches["lifecycle.bit_rot"] = counted(heal_rot)
        healed_s = time.monotonic() - t_flip
        holder = next(u for u, s in ec_holders(client, a).items()
                      if sid in s)
        if sha256_file(shard_file(cl, holder, col, a, sid)) != want:
            raise AssertionError(f"healed shard {sid} differs")
        checked, mounted = 0, 0
        for u in sorted({u for v in vids for u in ec_holders(client, v)}):
            out, n = scrub(cl, client, u)
            if out["bad"]:
                raise AssertionError(f"scrub of {u} after healing: {out}")
            checked += n
            mounted += mounted_on(u)
        if checked != mounted or mounted != 28:
            raise AssertionError(f"scrub checked {checked} of {mounted}")
        lc_log("lifecycle.bit_rot", healed_s,
               launches=launches["lifecycle.bit_rot"],
               trigger_to_action_s=healed_s, shard=sid, flipped_on=url,
               rebuilt_on=holder, sha256_equal=True,
               scrub_shards_checked=checked,
               scrub_shards_dropped=m.value("scrub_shards_dropped"))
        lc_read(client, "lifecycle.read_healed", fids[a], deleted[a], seed,
                a, launches)

        # 4. a holder dies: degraded reads, then the rebuild on the
        # survivors with no command
        lost_url = sorted(u for u, s in ec_holders(client, b).items()
                          if len(s) == 3)[0]
        lost_shards = {v: ec_holders(client, v).get(lost_url, [])
                       for v in vids}
        cl.stop_volume_server(cl.index_of(lost_url))
        t_stop = time.monotonic()

        def heal_death():
            # once the master has pruned the dead holder (a deleted
            # needle must answer 404, not a refused connection), its
            # shards are read degraded until the rebuild mounts them; the
            # reads' launches overlap the rebuild's and count in the step's
            wait_until(lambda: lost_url not in ec_holders(client, b),
                       "the master to prune the dead holder")
            lc_read(client, "lifecycle.read_degraded", fids[b], deleted[b],
                    seed, b, launches, stride=LC_SAMPLE)
            wait_until(lambda: all(
                len(client.ec_lookup(v).get("shards", {})) == 14
                and lost_url not in ec_holders(client, v) for v in vids),
                "the dead holder's shards rebuilt", timeout=600)

        _, launches["lifecycle.holder_death"] = counted(heal_death)
        death_s = time.monotonic() - t_stop
        lc_log("lifecycle.holder_death", death_s,
               launches=launches["lifecycle.holder_death"],
               trigger_to_action_s=death_s, lost=lost_url,
               lost_shards=lost_shards,
               shards_per_server={v: sorted(map(len, ec_holders(
                   client, v).values())) for v in vids})
        for vid in vids:
            lc_read(client, f"lifecycle.read_rebuilt_{vid}", fids[vid],
                    deleted[vid], seed, vid, launches, stride=LC_SAMPLE)

        # 5. a replica lost: the repair daemon copies it back where the
        # placement holds
        vid = client.grow(count=1, collection=LC_REP,
                          replication="001")["volume_ids"][0]
        pair = fresh_lookup(client, vid)
        first = holder_volume(cl, pair[0], vid)
        t0 = time.perf_counter()
        (rfids, _), launches["lifecycle.replica_upload"] = counted(
            lambda: upload_needles(client, vid, first.data_file_size,
                                   small, max_needle, seed + 1, LC_REP,
                                   "001", delete_share=0))
        lc_log("lifecycle.replica_upload", time.perf_counter() - t0,
               first.data_file_size(),
               launches=launches["lifecycle.replica_upload"],
               volume_id=vid, needles=len(rfids))
        client.volume_admin(pair[1], "volume/delete", {"volume_id": vid})
        t_del = time.monotonic()

        def two_copies():
            wait_until(lambda: len(fresh_lookup(client, vid)) == 2,
                       "the lost replica copied back", timeout=300)

        _, launches["lifecycle.replica_lost"] = counted(two_copies)
        back_s = time.monotonic() - t_del
        now = fresh_lookup(client, vid)
        lc_log("lifecycle.replica_lost", back_s,
               holder_volume(cl, now[0], vid).data_file_size(),
               launches=launches["lifecycle.replica_lost"],
               trigger_to_action_s=back_s, holders=now,
               replaced=pair[1])
        for i, url in enumerate(now):
            lc_read(client, f"lifecycle.read_replica_{i}", rfids, set(),
                    seed + 1, vid, launches, url=url)

        # 6. TTL expiry of a whole volume of lctmp
        vid = client.grow(count=1, collection=LC_TMP)["volume_ids"][0]
        url = fresh_lookup(client, vid)[0]
        tvol = holder_volume(cl, url, vid)
        t0 = time.perf_counter()
        (tfids, _), launches["lifecycle.ttl_upload"] = counted(
            lambda: upload_needles(client, vid, tvol.data_file_size,
                                   small, max_needle, seed + 2, LC_TMP,
                                   delete_share=0))
        t_last = time.monotonic()
        lc_log("lifecycle.ttl_upload", time.perf_counter() - t0,
               tvol.data_file_size(),
               launches=launches["lifecycle.ttl_upload"], volume_id=vid,
               needles=len(tfids))
        files = [os.path.join(n[3], f"{LC_TMP}_{vid}{ext}")
                 for n in cl.nodes if n[0] is not None
                 for ext in (".dat", ".idx")]

        def expired() -> bool:
            r = http.request("GET", f"http://{cl.master_url}/dir/lookup"
                             f"?volumeId={vid}")
            return r.status == 404 and not any(map(os.path.exists, files))

        def gone():
            wait_until(expired, "the TTL volume gone", timeout=300)

        _, launches["lifecycle.ttl_expiry"] = counted(gone)
        gone_s = time.monotonic() - t_last
        wait_until(lambda: ("expire", vid, "ok") in warm_outcomes(client),
                   "the expiry's outcome")
        lc_log("lifecycle.ttl_expiry", gone_s,
               launches=launches["lifecycle.ttl_expiry"],
               trigger_to_action_s=gone_s - LC_TTL - LC_TTL_GRACE,
               ttl_s=LC_TTL, grace_s=LC_TTL_GRACE, volume_id=vid)

        # 7. hot again: reads above the rate decode the warm volume; each
        # of its 256 smallest one-interval needles is read from the
        # holder of its shard, so that no read takes a peer's hop
        local = {}
        for u, sids in ec_holders(client, a).items():
            ev = cl.store(cl.index_of(u)).find_ec_volume(a)
            local.update({sid: (u, ev) for sid in sids})
        hot = {}
        for f in sorted((f for f in fids[a] if f not in deleted[a]),
                        key=lambda f: fids[a][f][1]):
            ev = next(iter(local.values()))[1]
            ivs = ev.locate(FileId.parse(f).key)[2]
            if len(ivs) == 1:
                hot[f] = local[ivs[0].to_shard_id_and_offset(ev.g)[0]][0]
            if len(hot) == 256:
                break
        hot_fids = sorted(hot)
        want_hot = {f: payload(seed, *fids[a][f]) for f in hot}
        stop = threading.Event()
        reads = [0] * hot_threads
        errors: list = []
        # (unix time, holder, error) of every read that failed
        failed: list = []

        def hammer(i: int) -> None:
            n = 0
            while not stop.is_set():
                fid = hot_fids[(i + n * hot_threads) % len(hot_fids)]
                n += 1
                try:
                    if client.download(fid, url=hot[fid]) != want_hot[fid]:
                        errors.append(f"{fid} reads back wrong")
                        return
                    reads[i] += 1
                except ClientError as e:
                    failed.append((time.time(), hot[fid], str(e)[:200]))
                    # a read may fail only where it was sent to a shard
                    # holder, and only once ec/to_volume has made the
                    # volume normal on one holder (the shards are then
                    # dropped everywhere); it then goes through the
                    # master's lookup, where no read may fail
                    if not hot[fid]:
                        errors.append(f"{fid} failed through the "
                                      f"lookup: {e}")
                        return
                    if not holds_normal(cl, a):
                        errors.append(f"{fid} failed before the decode: "
                                      f"{e}")
                        return
                    hot[fid] = ""
                    client._vid_cache.pop(a)

        def decode_hot():
            threads = [threading.Thread(target=hammer, args=(i,),
                                        daemon=True)
                       for i in range(hot_threads)]
            for t in threads:
                t.start()
            try:
                wait_until(lambda: holds_normal(cl, a) and not client
                           .ec_lookup(a).get("shards") or errors,
                           "the hot volume decoded", timeout=LC_HOT_TIMEOUT)
            finally:
                stop.set()
                for t in threads:
                    t.join(60)
                heat = client.volume_heat(a)["volumes"]
                log({"phase": "lifecycle.hot_reads", "reads": sum(reads),
                     "seconds": time.monotonic() - t_hot,
                     "heat_read_rate": heat[0]["read_rate"] if heat
                     else None, "card": SMI[0]})
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"hot reads: {errors[:3]}")

        t_hot = time.monotonic()
        _, launches["lifecycle.hot_again"] = counted(decode_hot)
        hot_s = time.monotonic() - t_hot
        wait_until(lambda: ("unec", a, "ok") in warm_outcomes(client),
                   "the decode's outcome")
        decoded_at = next(e["at"] for e in client.lifecycle_status()["recent"]
                          if (e["kind"], e["volume"], e["outcome"])
                          == ("unec", a, "ok"))
        lc_log("lifecycle.hot_again", hot_s,
               launches=launches["lifecycle.hot_again"],
               trigger_to_action_s=hot_s, reads=sum(reads),
               reads_per_s=sum(reads) / hot_s, hot_read_rate=hot_rate,
               threads=hot_threads, failed_reads=len(failed),
               failed_window_s=(decoded_at - failed[0][0] if failed
                                else 0.0),
               failed_after_outcome=sum(f[0] > decoded_at for f in failed),
               failed_by_answer=dict(collections.Counter(
                   f[2].rsplit(": ", 1)[-1] for f in failed)))
        lc_read(client, "lifecycle.read_decoded", fids[a], deleted[a],
                seed, a, launches, stride=LC_SAMPLE)
        states = {v["volume"]: v["state"]
                  for v in client.volume_heat()["volumes"]}
        log({"phase": "lifecycle.summary", "servers": 4,
             "volume_size_limit_mb": limit_mb, "volumes": vids,
             "warm_after_s": LC_WARM_AFTER, "interval_s": LC_INTERVAL,
             "hot_read_rate": hot_rate, "heat_halflife_s": LC_HALFLIFE,
             "collection_ttl_s": LC_TTL, "ttl_grace_s": LC_TTL_GRACE,
             "states": states, "outcomes": warm_outcomes(client),
             "repairs_succeeded": {k: m.value("repairs_succeeded",
                                              {"kind": k})
                                   for k in ("ec", "replica")},
             "repairs_failed": {k: m.value("repairs_failed", {"kind": k})
                                for k in ("ec", "replica")},
             "card": SMI[0]})
        if states.get(a) != "hot" or states.get(b) != "warm":
            raise AssertionError(f"states after phase 9: {states}")
    finally:
        cl.shutdown()
    shutil.rmtree(work, ignore_errors=True)
    return launches


def check_lifecycle_launches(launches: dict) -> None:
    """gf_apply in the coder's steps (and the direct warm-down check),
    nothing in any other step, no other kernel anywhere."""
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        coder = step in LIFECYCLE_CODER_STEPS + LIFECYCLE_CHECKS
        if others or coder != (counts["gf_apply"] > 0):
            raise AssertionError(f"{step}: launches {counts}")


def shard_size_of(rb: dict, cl, col: str, vid: int) -> int:
    d = cl.nodes[cl.index_of(rb["rebuilder"])][3]
    return os.path.getsize(os.path.join(d, f"{col}_{vid}")
                           + geometry.to_ext(rb["rebuilt"][0]))


def free_port() -> int:
    """A free loopback port whose gRPC twin (port + 10000, where a CLI
    master, volume server, filer or broker serves gRPC) is free too."""
    import socket
    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port + 10000 > 65535:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 10000))
            except OSError:
                continue
        return port
    raise OSError("no free port with a free gRPC twin")


def run_cli(work: Path, needles: int = 48) -> None:
    """(7b) ``python3 -m seaweedfs_torch.cli`` master and volume (``-coder
    auto``) as processes; uploads to a 64 MB volume, ``shell ec.encode``,
    one shard deleted, every needle read back."""
    work.mkdir(parents=True)
    seed = SEED + 9
    col = "clismoke"
    mport, vport = free_port(), free_port()
    cli = [sys.executable, "-m", "seaweedfs_torch.cli"]
    procs = []
    t0 = time.perf_counter()
    try:
        # no maintenance daemon: a deleted shard stays deleted
        for args in (["master", "-port", str(mport),
                      "-volumeSizeLimitMB", "64", "-pulse", "1",
                      "-maintenance_interval", "0"],
                     ["volume", "-port", str(vport), "-dir", str(work),
                      "-mserver", f"127.0.0.1:{mport}", "-pulse", "1",
                      "-coder", "auto"]):
            procs.append(subprocess.Popen(
                cli + args, cwd=str(REPO), stdout=subprocess.DEVNULL,
                stderr=open(work / f"{args[0]}.log", "wb")))
        client = Client(f"127.0.0.1:{mport}")

        def listed() -> bool:
            if any(p.poll() is not None for p in procs):
                raise AssertionError("a server process exited")
            try:
                return len(client.dir_status()["nodes"]) == 1
            except (OSError, ClientError):
                return False

        wait_until(listed, "the CLI cluster", timeout=120)
        started = time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        fids = {}
        for nid in range(1, needles + 1):
            size = int(np.exp(rng.uniform(np.log(1024), np.log(MIB))))
            fids[client.upload(payload(seed, nid, size),
                               collection=col)] = (nid, size)
        vids = {int(f.split(",")[0]) for f in fids}
        if len(vids) != 1:
            raise AssertionError(f"uploads spread over volumes {vids}")
        vid = vids.pop()
        t1 = time.perf_counter()
        out = subprocess.run(
            cli + ["shell", "-server", f"127.0.0.1:{mport}", "ec.encode",
                   "-volumeId", str(vid), "-collection", col],
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        encode_s = time.perf_counter() - t1
        if out.returncode != 0:
            raise AssertionError(f"shell ec.encode: {out.stderr[-2000:]}")
        plan = json.loads(out.stdout.strip().splitlines()[-1])
        info = client.ec_lookup(vid)
        if len(info["shards"]) != 14:
            raise AssertionError(f"CLI encode mounted {info}")
        client.volume_admin(f"127.0.0.1:{vport}", "ec/delete_shards",
                            {"volume_id": vid, "collection": col,
                             "shard_ids": [3]})
        read = http_read_all(client, fids, set(), seed)
        log({"phase": "cli.exit_test", "seconds": time.perf_counter() - t0,
             "startup_s": started, "shell_ec_encode_s": encode_s,
             "needles": len(fids), "volume_id": vid,
             "plan": {u: len(s) for u, s in plan["plan"].items()},
             "lost_shard": 3, "read_back": len(read["latencies"]),
             **latency_summary(read["latencies"])})
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    shutil.rmtree(work, ignore_errors=True)


# --- phase 10: the multi-card coder and the crash sweeps ----------------

MESH_GEOMETRIES = ((10, 4), (20, 4), (6, 3))
MESH_WIDTHS = (1, 1023, 64 * 1024 + 3, 8 * MIB + 5)
# the crash sweeps: sweep_all's defaults (phase 11e), phase 10d's points
# and source size (cut from 20 and 64 MiB to make room for phase 11)
CRASH_SEEDS, CRASH_POINTS = 2, 20
MESH_CRASH_POINTS = 10
CRASH_DAT_BYTES = 32 * MIB
# phases 3-4's volume, cut from 1 GiB to make room for phase 19 (this
# seed's 512 MiB volume keeps about 450 live needles on the lost shards
# {0, 3, 7, 12}; 3a's check wants 200)
MAIN_VOLUME_BYTES = 512 * MIB
# phases 7-8's volumes, cut from 1 GiB to make room for phase 12 (the
# smoke took about 1115 s on one H100 with them at 1 GiB), then from 512
# MiB for phase 14 (not below: 7a's check wants 200 needles on the lost
# server's shards; a 256 MiB volume of this seed puts 211 there, a 192
# MiB one 159)
CUT_VOLUME_BYTES = 256 * MIB
# phase 8's replicated volume: 7a's size until phase 18 (it has no
# per-shard needle bound of its own)
REPL_VOLUME_BYTES = 128 * MIB
# phase 6b's archive volume, phase 9's and phase 10b's volumes, cut from
# 1 GiB for phases 11 and 12, then from 512 MiB to make room for phase
# 13 (the smoke took about 1175 s on one H100 with them at 512 MiB), then
# from 256 MiB for phase 14
SMALL_VOLUME_BYTES = 128 * MIB


def mesh_log(row: dict) -> None:
    log({**row, "card": SMI[0]})


def mesh_devices(count: int) -> list:
    """Two members: distinct cards where the host has them, else the one
    card twice (each member still on its own stream)."""
    return ([torch.device("cuda", i) for i in range(2)] if count >= 2
            else [torch.device("cuda", 0)] * 2)


def only_kernel(counts: dict, kernel: str, n: int, what: str) -> None:
    """`kernel` launched exactly n times and no other kernel at all."""
    if counts[kernel] != n or any(c for name, c in counts.items()
                                  if name != kernel):
        raise AssertionError(f"{what}: launches {counts}, want {n} of "
                             f"{kernel} and nothing else")


def check_mesh_kernels(devices: list) -> int:
    """(10a) The mesh's encode and rebuild, and the batched surface,
    bit-equal to single-card gf_apply and to the plain version; returns
    the cases checked."""
    dev = devices[0]
    smesh = sharded.make_mesh(devices=devices)
    cases = 0
    t0 = time.perf_counter()
    for k, m in MESH_GEOMETRIES:
        present, victims = lost(k, m)
        w_par = rs_torch.load_matrix(gf256.parity_matrix(k, m), dev)
        w_rec = rs_torch.load_matrix(gf256.reconstruction_matrix(
            k, m, present, victims), dev)
        meshes = {f: mesh_mod.MeshCoder(k, m, devices=devices,
                                        formulation=f)
                  for f in FORMULATION_KERNEL}
        for width in MESH_WIDTHS:
            rng = np.random.default_rng((SEED, k, width))
            data = rng.integers(0, 256, (k, width), dtype=np.uint8)
            flipped = np.ascontiguousarray(data[::-1])
            parity, flipped_parity = (
                rs_cuda.gf_apply(w_par, torch.from_numpy(x).to(dev))
                .cpu().numpy() for x in (data, flipped))
            rows = [*data, *parity]
            surv = np.stack([rows[i] for i in present])
            sd = torch.from_numpy(surv).to(dev)
            rebuilt = rs_cuda.gf_apply(w_rec, sd).cpu().numpy()
            plain = (rs_torch.gf_apply(w_par, torch.from_numpy(data)
                                       .to(dev)).cpu().numpy(),
                     rs_torch.gf_apply(w_rec, sd).cpu().numpy())
            if not (np.array_equal(parity, plain[0])
                    and np.array_equal(rebuilt, plain[1])
                    and np.array_equal(rebuilt, np.stack(
                        [rows[v] for v in victims]))):
                raise AssertionError(f"RS({k},{m}) width {width}: gf_apply "
                                     "differs from the plain version")
            holed = [None if i in victims else r for i, r in enumerate(rows)]
            for f, mesh in meshes.items():
                kernel = FORMULATION_KERNEL[f]
                what = f"mesh RS({k},{m}) {f} width {width}"
                got, n = counted(lambda: mesh.encode(data))
                only_kernel(n, kernel, len(devices), what + " encode")
                if not np.array_equal(got, parity):
                    raise AssertionError(what + ": parity differs")
                got, n = counted(lambda: mesh.materialize(
                    mesh.rec_apply_async(present, victims)(surv)))
                only_kernel(n, kernel, len(devices), what + " rebuild")
                if not np.array_equal(got, rebuilt):
                    raise AssertionError(what + ": rebuild differs")
                # one stripe per member, the two kinds alternating
                got, n = counted(lambda: sharded.sharded_encode(
                    smesh, np.stack([(data, flipped)[i % 2]
                                     for i in range(len(devices))]), m, f))
                only_kernel(n, kernel, len(devices), what + " sharded")
                if not all(np.array_equal(g, (parity, flipped_parity)[i % 2])
                           for i, g in enumerate(got)):
                    raise AssertionError(what + ": sharded_encode differs")
                out, n = counted(lambda: sharded.sharded_rebuild(
                    smesh, holed, k, m, f))
                only_kernel(n, kernel, len(devices),
                            what + " sharded_rebuild")
                if not all(np.array_equal(out[v], rows[v])
                           for v in victims):
                    raise AssertionError(what + ": sharded_rebuild differs")
                cases += 1
    mesh_log({"phase": "mesh.kernels_vs_single_and_plain", "cases": cases,
              "members": [str(d) for d in devices],
              "geometries": [f"RS({k},{m})" for k, m in MESH_GEOMETRIES],
              "widths": list(MESH_WIDTHS),
              "formulations": list(FORMULATION_KERNEL),
              "bit_equal": True, "seconds": time.perf_counter() - t0})
    return cases


def chip_staged(n: int) -> list:
    reg = metrics.shared("ec")
    return [reg.value("feed_chip_staged_bytes", {"chip": str(i)})
            for i in range(n)]


def run_mesh_path(work: Path, devices: list, device: torch.device,
                  total: int = 1 << 30) -> dict:
    """(10b) A volume through stream_encode single-card and through
    the mesh over `devices` in each formulation, rebuild and sinks;
    returns launches per step."""
    volume = source_volume(work / "src", total, 4 * MIB, SEED + 10,
                           "mesh.")
    g = geometry.DEFAULT
    members = len(devices)
    launches = {}
    single = coder_mod.TorchCoder(g.data_shards, g.parity_shards,
                                  device=device)
    shutil.copytree(volume["dir"], work / "single")
    base = str(work / "single" / "1")
    dat_size = os.path.getsize(base + ".dat")
    governor.reset()
    _, launches["mesh.single_stream_encode"] = timed(
        "mesh.single_stream_encode",
        lambda: counted(lambda: pipeline.stream_encode(base, single, g)),
        lambda r: dat_size, lambda r: {"launches": r[1], "card": SMI[0]})
    want = shard_shas(base, g)
    shutil.rmtree(work / "single")
    for f, kernel in FORMULATION_KERNEL.items():
        mesh = mesh_mod.MeshCoder(g.data_shards, g.parity_shards,
                                  devices=devices, formulation=f)
        tag = f"mesh.{f}."
        shutil.copytree(volume["dir"], work / f)
        base = str(work / f / "1")
        governor.reset()
        op = governor.get().plan(dat_size, g.data_shards,
                                 chips=pipeline.coder_chips(mesh))
        before = chip_staged(members)
        with call_counter(mesh, "_stage_cols") as staged:
            _, n = timed(
                f"{tag}stream_encode",
                lambda: counted(lambda: pipeline.stream_encode(base, mesh,
                                                               g)),
                lambda r: dat_size,
                lambda r: {"launches": r[1], "card": SMI[0],
                           "plan": {"chips": op.chips,
                                    "batch_size": op.batch_size,
                                    "depth": op.depth}})
        grown = [a - b for a, b in zip(chip_staged(members), before)]
        gauge = governor.get().metrics.value("feed_mesh_devices")
        mesh_log({"phase": f"{tag}plan", "chips": op.chips,
                  "feed_mesh_devices": gauge, "batches": staged.calls,
                  "chip_staged_bytes": grown})
        if op.chips != members or gauge != members or min(grown) <= 0:
            raise AssertionError(f"{tag}: plan chips {op.chips}, gauge "
                                 f"{gauge}, staged per chip {grown}")
        only_kernel(n, kernel, members * staged.calls,
                    f"{tag}stream_encode")
        launches[f"{tag}stream_encode"] = n
        if shard_shas(base, g) != want:
            raise AssertionError(f"{tag}: shards differ from the "
                                 "single-card run's")
        for v in VICTIMS:
            os.remove(base + geometry.to_ext(v))
        with call_counter(mesh, "_stage_rows") as staged:
            (rebuilt, n) = timed(
                f"{tag}stream_rebuild",
                lambda: counted(lambda: pipeline.stream_rebuild(base, mesh,
                                                                g)),
                lambda r: os.path.getsize(base + geometry.to_ext(1))
                * g.data_shards, lambda r: {"launches": r[1],
                                            "card": SMI[0]})
        only_kernel(n, kernel, members * staged.calls,
                    f"{tag}stream_rebuild")
        launches[f"{tag}stream_rebuild"] = n
        if rebuilt != list(VICTIMS) or shard_shas(base, g) != want:
            raise AssertionError(f"{tag}: rebuilt shards differ")
        with call_counter(mesh, "_stage_cols") as staged:
            sinks = check_sinks(base, mesh, g, tag)
        only_kernel({k: sum(c[k] for c in sinks.values())
                     for k in WRAPPERS}, kernel, members * staged.calls,
                    f"{tag}device sinks")
        launches.update({f"{tag}{k}": c for k, c in sinks.items()})
        shutil.rmtree(work / f)
        mesh_log({"phase": f"{tag}summary", "members":
                  [str(d) for d in devices], "shards_sha256_equal": True,
                  "rebuilt_sha256_equal": True, "sink_digests_equal": True})
    shutil.rmtree(work, ignore_errors=True)
    return launches


def run_mesh_surface(work: Path, card: str, count: int) -> None:
    """(10c) WEED_EC_MESH_DEVICES=all: the Store's lift, and the mesh
    status over HTTP and through the shell."""
    work.mkdir(parents=True)
    with env_set(WEED_EC_MESH_DEVICES="all"):
        st = store_mod.Store([str(work / "lift")], coder_name="auto")
        try:
            c = st.coder()
        finally:
            st.close()
        lifted = (isinstance(c, mesh_mod.MeshCoder)
                  and c.mesh_devices == count) if count >= 2 else (
            type(c) is coder_mod.TorchCoder and c.device.type == "cuda")
        if not lifted:
            raise AssertionError(f"Store coder under WEED_EC_MESH_DEVICES="
                                 f"all on {count} card(s): {c!r}")
        cl = LocalCluster(1, coder_name="auto", volume_size_limit_mb=64,
                          pulse=0.5, directory=str(work / "cluster"))
        try:
            cl.wait_for_nodes(1)
            http_status = http_get_json(
                f"http://{cl.url(0)}/admin/ec/mesh_status")
            shell_commands._register_all()
            env = shell_commands.CommandEnv(Client(cl.master_url))
            shell = shell_commands.run_command(env, ["ec.mesh.status"])
        finally:
            cl.shutdown()
    for answer in (http_status, *shell["nodes"].values()):
        if (answer.get("requested") != "all" or "mesh_devices" not in answer
                or card not in [d["name"] for d in answer["devices"]]):
            raise AssertionError(f"mesh status {answer}")
    mesh_log({"phase": "mesh.surface", "store_coder": type(c).__name__,
              "mesh_devices": getattr(c, "mesh_devices", 1),
              "http": {k: http_status[k] for k in
                       ("requested", "mesh_devices", "devices")},
              "shell_nodes": len(shell["nodes"])})
    shutil.rmtree(work, ignore_errors=True)


def crash_workloads(device: torch.device) -> list:
    """(10d) The crash workloads at the card's sizes: ec_encode on phase
    4's mixed tiers, fused_warmdown on phase 6b's payload kinds,
    volume_append, raft_snapshot, filer_kv and offset_commit at their
    defaults."""
    seed = SEED + 11
    mixed = geometry.Geometry(large_block_size=262144,
                              small_block_size=16384)
    ec_encode = crash_wl.make_ec_workload(
        coder=coder_mod.get_coder("auto", 10, 4), geometry=mixed,
        dat_size=CRASH_DAT_BYTES,
        dat_source=lambda n: np.random.default_rng(seed).bytes(n),
        encode=pipeline.stream_encode)
    count, stored = 0, 0
    while stored < CRASH_DAT_BYTES:
        count += 1
        stored += len(archive_needle(seed, count).data)
    rng = np.random.default_rng(seed)
    gone = {int(i) + 1 for i in rng.choice(count, size=int(0.3 * count),
                                           replace=False)}
    fused = crash_wl.make_fused_warmdown_workload(
        coder=coder_mod.get_coder("auto", 20, 4),
        geometry=geometry.Geometry(20, 4), needles=count, deleted=gone,
        make_needle=lambda nid: archive_needle(seed, nid))
    return [ec_encode, fused, crash_wl.make_volume_workload(),
            crash_wl.make_raft_workload(), crash_wl.make_filer_kv_workload(),
            crash_wl.make_offset_workload()]


def run_crash_sweeps(work: Path, device: torch.device) -> dict:
    """(10d) Each workload at CRASH_SEEDS x MESH_CRASH_POINTS; zero
    violations, gf_apply launched in both EC sweeps and in no other.
    Returns launches per sweep."""
    work.mkdir(parents=True)
    launches = {}
    for w in crash_workloads(device):
        t0 = time.perf_counter()
        summary, n = counted(lambda: crash_harness.sweep_all(
            seeds=CRASH_SEEDS, points=MESH_CRASH_POINTS, workloads=[w],
            scratch_dir=str(work)))
        secs = time.perf_counter() - t0
        runs = summary["workloads"][w.name]
        mesh_log({"phase": f"crash.{w.name}", "seconds": secs,
                  "points": summary["total_points"],
                  "violations": summary["total_violations"],
                  "ops": [r["ops"] for r in runs], "launches": n,
                  "first_violations": [v for r in runs
                                       for v in r["violations"]][:3]})
        if not summary["ok"] or summary["total_points"] != \
                CRASH_SEEDS * MESH_CRASH_POINTS:
            raise AssertionError(f"crash sweep {w.name}: {summary}")
        ec_sweep = w.name in ("ec_encode", "fused_warmdown")
        if (ec_sweep != (n["gf_apply"] > 0)
                or any(c for k, c in n.items() if k != "gf_apply")):
            raise AssertionError(f"crash.{w.name}: launches {n}")
        launches[f"crash.{w.name}"] = n
    shutil.rmtree(work, ignore_errors=True)
    return launches


def run_mesh(work: Path, device: torch.device, card: str,
             count: int) -> dict:
    """Phase 10; returns the main path's launches per step."""
    devices = mesh_devices(count)
    t0 = time.perf_counter()
    check_mesh_kernels(devices)
    launches = run_mesh_path(work / "path", devices, device,
                             total=SMALL_VOLUME_BYTES)
    run_mesh_surface(work / "surface", card, count)
    launches.update(run_crash_sweeps(work / "crash", device))
    mesh_log({"phase": "mesh.summary", "seconds": time.perf_counter() - t0,
              "members": [str(d) for d in devices], "launches": launches})
    return launches


# --- phase 11: the auto-balancer and the volume server's data path ------

BAL_COLLECTION = "balsmoke"
BAL_AB = "balgc"          # the fifth volume: group commit off, then on
BAL_NEW = "balnew"        # a volume grown after the moves
# upstream's 30 GB volume size limit, cut to 256 MiB, then to 192 MiB
# for phase 12, to 160 MiB for phase 13, to 96 MiB for phase 14, to 64
# MiB for phase 15 and to 40 MiB for phase 18 (the fifth volume's about
# 28 MiB of group-commit uploads stay under 0.9 of it)
BAL_LIMIT_MB = 40
BAL_FULL = 4              # the full 010 volumes of step 11a
BAL_CLIENTS = 64
BAL_PROCS = 4             # uploader processes (16 clients each)
# 4000 before phase 14, 2000 before phase 15, 1500 before phase 18
BAL_AB_NEEDLES = 900
BAL_MAX_NEEDLE = 64 * 1024
BAL_ASSIGN_COUNT = 16     # keys per /dir/assign?count=
# the balancer's and the volume servers' knobs, read at construction
BAL_ENV = {"WEED_BALANCE_ENABLED": "1", "WEED_BALANCE_INTERVAL": "1",
           "WEED_BALANCE_COOLDOWN": "30",
           "WEED_LIFECYCLE_HEAT_HALFLIFE": "2",
           "WEED_VOLUME_GROUP_COMMIT_US": "2000"}
# a read of a corrupt needle whose only peer is down: answered within
# this many seconds (a connect timeout would take 10)
BAL_FAST_500_S = 2.0
# 11d reads every 8th needle of the moved volume with a holder stopped
# (every needle before phase 12: 18416 reads, 101.5 s on one H100; every
# 4th before phase 17's smoke reached 1126 s: 1280 reads, 25.7 s)
BAL_DEGRADED_STRIDE = 8
# steps of phase 11 that run the coder (gf_apply must launch there, and
# in no other step of the phase)
BALANCE_CODER_STEPS = ("balance.ec_mid_encode", "balance.ec_encode",
                       "balance.read_degraded")


def bal_log(step: str, secs: float, launches=None, **extra) -> None:
    row = {"phase": step, "seconds": secs}
    if launches is not None:
        row["launches"] = launches
    row.update(extra)
    row["card"] = SMI[0]
    log(row)


class fsync_counter:
    """Count os.fsync calls for a block (every thread of the process)."""

    def __enter__(self):
        self.count = 0
        self._lock = threading.Lock()
        self._real = os.fsync

        def fsync(fd):
            with self._lock:
                self.count += 1
            return self._real(fd)

        os.fsync = fsync
        return self

    def __exit__(self, *exc):
        os.fsync = self._real


def bal_upload(master_url: str, collection: str, seed: int, stop,
               limit: int, counter, threads: int = BAL_CLIENTS) -> dict:
    """`threads` clients upload phase 3's generator's needles (log-uniform
    1 KiB .. 64 KiB) until `stop()` or `limit` uploads; each client takes
    a block of keys per assign (``count=``). Returns fid -> (nid, size),
    the acknowledgement latencies and the wall seconds."""
    acked: dict = {}
    lat: list = []
    lock = threading.Lock()
    errors: list = []

    def client_loop(i: int) -> None:
        client = Client(master_url)
        rng = np.random.default_rng((seed, i))
        try:
            while not stop() and len(acked) < limit:
                a = client.assign(count=BAL_ASSIGN_COUNT,
                                  collection=collection)
                base = FileId.parse(a["fid"])
                for k in range(BAL_ASSIGN_COUNT):
                    if stop() or len(acked) >= limit:
                        return
                    nid = next(counter)
                    size = int(np.exp(rng.uniform(np.log(1024),
                                                  np.log(BAL_MAX_NEEDLE))))
                    fid = str(FileId(base.volume_id, base.key + k,
                                     base.cookie))
                    t0 = time.perf_counter()
                    client.upload_blob(a["url"], fid,
                                       payload(seed, nid, size))
                    dt = time.perf_counter() - t0
                    with lock:
                        acked[fid] = (nid, size)
                        lat.append(dt)
        except Exception as e:
            errors.append(repr(e))

    t0 = time.perf_counter()
    workers = [threading.Thread(target=client_loop, args=(i,), daemon=True)
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    secs = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"uploads failed: {errors[:3]}")
    return {"acked": acked, "lat": lat, "seconds": secs}


def _upload_proc(master_url: str, collection: str, seed: int,
                 first_nid: int, threads: int, limit: int, stop,
                 out) -> None:
    """One uploader process: `threads` clients of ``bal_upload``, needle
    ids counted from `first_nid`; puts (acked, latencies, its clients'
    seconds) on `out`."""
    up = bal_upload(master_url, collection, seed, stop.is_set, limit,
                    itertools.count(first_nid), threads=threads)
    out.put((up["acked"], up["lat"], up["seconds"]))


def bal_upload_procs(master_url: str, collection: str, seed: int, done,
                     limit: int, run: int,
                     procs: int = BAL_PROCS) -> dict:
    """``BAL_CLIENTS`` clients in `procs` processes (each its own
    interpreter, so the clients do not share the servers' GIL) until
    `done()` holds or each process has `limit` acknowledgements; needle
    ids are unique per (`run`, process). Returns fid -> (nid, size), the
    latencies and the longest process's seconds from its clients' start
    to their end (an interpreter's start is not counted)."""
    ctx = mp.get_context("spawn")
    stop, out = ctx.Event(), ctx.Queue()
    workers = [ctx.Process(target=_upload_proc, args=(
        master_url, collection, seed, 1 + (run * procs + i) * 10 ** 8,
        BAL_CLIENTS // procs, limit, stop, out), daemon=True)
        for i in range(procs)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    results: list = []
    try:
        while len(results) < procs:
            if done():
                stop.set()
            try:
                results.append(out.get(timeout=0.2))
            except queue.Empty:
                if not any(w.is_alive() for w in workers) and out.empty():
                    raise AssertionError("an uploader process died")
    finally:
        stop.set()
        for w in workers:
            w.join(30)
            if w.is_alive():
                w.kill()
    acked, lat = {}, []
    for a, lt, _ in results:
        acked.update(a)
        lat += lt
    return {"acked": acked, "lat": lat,
            "seconds": max(r[2] for r in results),
            "wall_s": time.perf_counter() - t0}


def _verify_files(base: str, want: list, seed: int) -> dict:
    """One holder's copy of a volume read from its files (.idx entries,
    then each record from the .dat, CRC checked): each (key, cookie, nid,
    size) of `want` present with the generator's bytes."""
    with open(base + ".dat", "rb") as f:
        sb = SuperBlock.from_bytes(f.read(8))
        entries = {}
        for key, off, size in idx_mod.iter_index_file(
                base + ".idx", offset_size=sb.offset_size):
            entries[key] = (off, size)
        out = {"reads": 0, "bytes": 0, "failed": collections.Counter()}
        for key, cookie, nid, size in want:
            off, stored = entries.get(key, (0, -1))
            if not off or not st_types.size_is_valid(stored):
                out["failed"]["missing"] += 1
                continue
            f.seek(st_types.stored_to_offset(off))
            try:
                n = Needle.from_bytes(
                    f.read(st_types.get_actual_size(stored, sb.version)),
                    sb.version)
            except ValueError:
                out["failed"]["crc"] += 1
                continue
            data = compression.decompress(n.data) if n.is_compressed \
                else n.data
            if n.cookie != cookie or data != payload(seed, nid, size):
                out["failed"]["wrong bytes"] += 1
                continue
            out["reads"] += 1
            out["bytes"] += size
    return out


def bal_read_files(cl, by_vid: dict, holders: dict, collection_of,
                   seed: int) -> dict:
    """Every needle of every volume from each holder's files, one process
    per (volume, holder) copy."""
    jobs = []
    for vid, items in by_vid.items():
        want = [(FileId.parse(f).key, FileId.parse(f).cookie, n, s)
                for f, n, s in items]
        for url in holders[vid]:
            base = os.path.join(cl.nodes[cl.index_of(url)][3],
                                f"{collection_of(vid)}_{vid}")
            jobs.append((base, want, seed))
    with mp.get_context("spawn").Pool(min(8, len(jobs))) as pool:
        parts = pool.starmap(_verify_files, jobs)
    out = {"reads": 0, "bytes": 0, "failed": collections.Counter()}
    for p in parts:
        out["reads"] += p["reads"]
        out["bytes"] += p["bytes"]
        out["failed"].update(p["failed"])
    return out


def bal_read(master_url: str, items: list, seed: int, url_by_vid: dict,
             threads: int = 8) -> dict:
    """Each (fid, nid, size) read over HTTP from the holder
    url_by_vid[vid] at `threads` threads, byte-compared with the
    generator; returns bytes, latencies and failures by cause."""
    lock = threading.Lock()
    out = {"bytes": 0, "lat": [], "failed": collections.Counter()}

    def part(chunk: list) -> None:
        client = Client(master_url)
        for fid, nid, size in chunk:
            t0 = time.perf_counter()
            try:
                data = client.download(fid, url=url_by_vid[
                    FileId.parse(fid).volume_id])
            except (ClientError, OSError) as e:
                with lock:
                    out["failed"][str(e)[-40:]] += 1
                continue
            dt = time.perf_counter() - t0
            with lock:
                if data != payload(seed, nid, size):
                    out["failed"]["wrong bytes"] += 1
                else:
                    out["bytes"] += size
                    out["lat"].append(dt)

    chunks = [items[i::threads] for i in range(threads)]
    workers = [threading.Thread(target=part, args=(c,), daemon=True)
               for c in chunks]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return out


def bal_read_procs(master_url: str, items: list, seed: int,
                   url_by_vid: dict, procs: int = BAL_PROCS) -> dict:
    """``bal_read`` over `procs` processes (8 client threads each), so
    the readers do not share the servers' GIL."""
    with mp.get_context("spawn").Pool(procs) as pool:
        parts = pool.starmap(bal_read, [
            (master_url, items[i::procs], seed, url_by_vid)
            for i in range(procs)])
    out = {"bytes": 0, "lat": [], "failed": collections.Counter()}
    for p in parts:
        out["bytes"] += p["bytes"]
        out["lat"] += p["lat"]
        out["failed"].update(p["failed"])
    return out


def bal_full_vids(cl, collection: str) -> list:
    """Volumes of `collection` the master lists at or past the size
    limit."""
    limit = cl.master.topology.volume_size_limit
    full = set()
    for node in list(cl.master.topology.nodes.values()):
        for vid, vi in list(node.volumes.items()):
            if vi.collection == collection and vi.size >= limit:
                full.add(vid)
    return sorted(full)


def bal_holders(cl, vid: int) -> list:
    return sorted(n.url for n in cl.master.topology.lookup(vid))


def flip_needle_byte(cl, url: str, vid: int, fid: str) -> None:
    """Flip one byte of a needle's data in one holder's .dat (bit rot
    under a live volume)."""
    v = holder_volume(cl, url, vid)
    nv = v.nm.get(FileId.parse(fid).key)
    off = st_types.stored_to_offset(nv.offset) + \
        st_types.NEEDLE_HEADER_SIZE + 4 + min(10, nv.size - 5)
    path = v.base_file_name() + ".dat"
    fd = os.open(path, os.O_RDWR)
    try:
        b = os.pread(fd, 1, off)
        os.pwrite(fd, bytes([b[0] ^ 0xFF]), off)
    finally:
        os.close(fd)


def vs_metric(cl, url: str, name: str) -> float:
    return cl.nodes[cl.index_of(url)][0].metrics.value(name)


def run_balance(work: Path, limit_mb: int = BAL_LIMIT_MB,
                ab_needles: int = BAL_AB_NEEDLES, pulse: float = 0.5,
                coder_name: str = "auto", device=None,
                sim_nodes: int = 1000) -> dict:
    """(11) The auto-balancer and the volume server's data path, in its
    own cluster: a master with the repair daemon (off for the last read
    only), a lifecycle daemon whose rules do not fire within the phase,
    and the balancer (a pass every second), 4 volume servers on 2 racks,
    default replication 010, group commit at 2 ms. Returns launches per
    step."""
    work.mkdir(parents=True)
    seed = SEED + 12
    launches: dict = {}
    observe.reset()
    cfg = LifecycleConfig(warm_after=3600.0, interval=LC_INTERVAL)
    with env_set(**BAL_ENV):
        cl = LocalCluster(
            4, coder_name=coder_name, device=device,
            volume_size_limit_mb=limit_mb, pulse=pulse,
            directory=str(work / "cluster"), racks=2,
            master_kwargs={"lifecycle_config": cfg,
                           "default_replication": "010",
                           "maintenance_interval_seconds": pulse},
            volume_kwargs={"scrub_interval_seconds": 0})
    try:
        client = Client(cl.master_url)
        env = shell_commands.CommandEnv(client, geometry.DEFAULT)
        shell_commands._register_all()
        # the operator's admin lease over the bulk load, its checks and
        # the heat of 11c: no daemon moves a volume read from a named
        # holder meanwhile
        lease = client.admin_lock
        lease.__enter__()

        # (11a) group-commit fill until four 010 volumes are full
        def fill():
            with fsync_counter() as fc:
                up = bal_upload_procs(
                    cl.master_url, BAL_COLLECTION, seed,
                    lambda: len(bal_full_vids(cl, BAL_COLLECTION))
                    >= BAL_FULL, 1 << 40, run=0)
            up["fsyncs"] = fc.count
            return up

        up, launches["balance.fill"] = counted(fill)
        acked = up["acked"]
        full = bal_full_vids(cl, BAL_COLLECTION)[:BAL_FULL]
        by_vid: dict = collections.defaultdict(list)
        for fid, (nid, size) in acked.items():
            by_vid[FileId.parse(fid).volume_id].append((fid, nid, size))
        bal_log("balance.fill", up["seconds"], launches["balance.fill"],
                uploads=len(acked),
                uploads_per_s=len(acked) / up["seconds"],
                bytes=sum(s for _, s in acked.values()),
                **{"ack_" + k: v for k, v in
                   latency_summary(up["lat"]).items() if k != "reads"},
                fsyncs=up["fsyncs"],
                fsyncs_per_upload=up["fsyncs"] / len(acked),
                full_volumes=full, clients=BAL_CLIENTS,
                volumes={str(v): len(by_vid[v]) for v in sorted(by_vid)})
        if len(full) < BAL_FULL:
            raise AssertionError(f"full volumes {full}")
        # group commit off, then on, into a fifth volume
        rates = {}
        ab: dict = {}
        for run, tag, us in ((1, "off", 0), (2, "on", int(BAL_ENV[
                "WEED_VOLUME_GROUP_COMMIT_US"]))):
            for node in cl.nodes:
                node[0]._batcher.group_commit_us = us
            with fsync_counter() as fc:
                r, n = counted(lambda: bal_upload_procs(
                    cl.master_url, BAL_AB, seed, lambda: False,
                    ab_needles // BAL_PROCS, run=run))
            launches[f"balance.group_commit_{tag}"] = n
            ab.update(r["acked"])
            rates[tag] = {"uploads": len(r["acked"]),
                          "uploads_per_s": len(r["acked"]) / r["seconds"],
                          "fsyncs": fc.count,
                          **{"ack_" + k: v for k, v in latency_summary(
                              r["lat"]).items() if k != "reads"}}
        ab_vids = sorted({FileId.parse(f).volume_id for f in ab})
        bal_log("balance.group_commit_ab", 0.0, rates=rates,
                volumes=ab_vids,
                launches={t: launches[f"balance.group_commit_{t}"]
                          for t in rates})
        for fid, (nid, size) in ab.items():
            by_vid[FileId.parse(fid).volume_id].append((fid, nid, size))
        # every acknowledged needle, from both holders' files
        holders = {v: bal_holders(cl, v) for v in by_vid}
        if any(len(h) != 2 for h in holders.values()):
            raise AssertionError(f"holders {holders}")
        t0 = time.perf_counter()
        got, launches["balance.read_both_holders"] = counted(
            lambda: bal_read_files(
                cl, by_vid, holders,
                lambda v: BAL_AB if v in ab_vids else BAL_COLLECTION,
                seed))
        want = 2 * sum(len(x) for x in by_vid.values())
        if got["failed"] or got["reads"] != want:
            raise AssertionError(f"read back {got['reads']} of {want}: "
                                 f"{dict(got['failed'])}")
        bal_log("balance.read_both_holders", time.perf_counter() - t0,
                launches["balance.read_both_holders"], reads=got["reads"],
                bytes=got["bytes"])

        # (11b) read repair on the writable fifth volume
        def repair_reads():
            vid = ab_vids[0]
            a, b = holders[vid]
            rot, lost = by_vid[vid][0], by_vid[vid][1]
            before = {k: vs_metric(cl, a, k)
                      for k in ("read_crc_repair", "read_repair")}
            flip_needle_byte(cl, a, vid, rot[0])
            t0 = time.perf_counter()
            if client.download(rot[0], url=a) != payload(seed, rot[1],
                                                          rot[2]):
                raise AssertionError("read repair served wrong bytes")
            crc_s = time.perf_counter() - t0
            after = {k: vs_metric(cl, a, k) for k in before}
            client.download(rot[0], url=a)
            local = vs_metric(cl, a, "read_repair") == after["read_repair"]
            if [after[k] - before[k] for k in before] != [1, 1] \
                    or not local:
                raise AssertionError(f"crc repair counters {before} -> "
                                     f"{after}, next read local {local}")
            holder_volume(cl, a, vid).nm._map.pop(FileId.parse(lost[0]).key)
            t0 = time.perf_counter()
            if client.download(lost[0], url=a) != payload(
                    seed, lost[1], lost[2]):
                raise AssertionError("lost write repaired wrong")
            lost_s = time.perf_counter() - t0
            if vs_metric(cl, a, "read_repair") != after["read_repair"] + 1:
                raise AssertionError("lost write not repaired")
            return {"volume": vid, "holder": a, "peer": b,
                    "crc_repair_s": crc_s, "lost_write_repair_s": lost_s}

        t0 = time.perf_counter()
        rep, launches["balance.read_repair"] = counted(repair_reads)
        bal_log("balance.read_repair", time.perf_counter() - t0,
                launches["balance.read_repair"], **rep)

        # (11c) the balancer: sealed volumes, one node read hot
        t0 = time.perf_counter()
        for vid in full:
            for url in holders[vid]:
                shell_commands.run_command(
                    env, ["volume.mark", "-volumeId", str(vid), "-node",
                          url, "-readonly"])
        per_node = collections.Counter(u for v in full for u in holders[v])
        hot = max(sorted(per_node), key=per_node.get)
        hot_vids = [v for v in full if hot in holders[v]][:2]
        if len(hot_vids) < 2:
            raise AssertionError(f"no node holds two full volumes: "
                                 f"{holders}")
        # one of the two caught mid-encode: its shard set generated and
        # mounted on the hot node beside its copies, as an ec.encode
        # shows it before the copies go. It stays among the volumes read
        # hot, so only the planner's EC rule keeps it where it is
        mid_vid = hot_vids[0]

        def mid_encode() -> None:
            client.volume_admin(hot, "ec/generate",
                                {"volume_id": mid_vid,
                                 "collection": BAL_COLLECTION})
            client.volume_admin(hot, "ec/mount", {
                "volume_id": mid_vid, "collection": BAL_COLLECTION,
                "shard_ids": list(range(geometry.DEFAULT.total_shards))})
            wait_until(lambda: cl.master.topology.lookup_ec_shards(
                mid_vid), "the mid-encode shards in the topology")

        _, launches["balance.ec_mid_encode"] = counted(mid_encode)
        plans: list = []
        plan_moves = balance_daemon.plan_moves

        def recorded_plan(*args, **kwargs):
            out = plan_moves(*args, **kwargs)
            plans.append([mv.vid for mv in out])
            return out

        balance_daemon.plan_moves = recorded_plan
        heat_items = [x for v in hot_vids for x in by_vid[v][:2000]]
        ranked = threading.Event()
        reads = collections.Counter()

        def heat_loop(i: int) -> None:
            c = Client(cl.master_url)
            mine = heat_items[i::8]
            k = 0
            while not ranked.is_set():
                fid = mine[k % len(mine)][0]
                k += 1
                c.download(fid, url=hot)
                reads[i] += 1

        heaters = [threading.Thread(target=heat_loop, args=(i,),
                                    daemon=True) for i in range(8)]
        for h in heaters:
            h.start()

        def is_hot() -> bool:
            st = shell_commands.run_command(
                env, ["cluster.balance.status", "-hot", "1"])
            top = st["node_rates"]
            rates = client.balance_status()["node_rates"]
            mean = sum(rates.values()) / max(len(rates), 1)
            cut = max(mean * st["config"]["hot_ratio"],
                      st["config"]["min_rate"])
            return list(top) == [hot] and top[hot] > cut

        # hot, and read for two half-lives at least: the rate the node
        # reports then stands well above what the probe below adds. The
        # operator's lease is still held, 3 s past that too: no move may
        # start under it
        heat_min = time.monotonic() + 2 * float(
            BAL_ENV["WEED_LIFECYCLE_HEAT_HALFLIFE"])
        wait_until(lambda: is_hot() and time.monotonic() > heat_min,
                   "the node ranked hot", timeout=300)
        hot_rates = client.balance_status()["node_rates"]
        ranked.set()
        for h in heaters:
            h.join()
        heat_s = time.perf_counter() - t0
        lease_pending = []
        end = time.monotonic() + 3.0
        while time.monotonic() < end:
            lease_pending += client.balance_status()["pending"]
            time.sleep(0.1)
        under_lease = client.balance_status()
        if lease_pending or under_lease["moves_done"]:
            raise AssertionError(f"moves under the admin lease: "
                                 f"{under_lease['recent']}")
        # reads through the lookup all through the moves, each from a
        # holder the lookup lists, at about 20 a second (a faster probe
        # would itself make a node hot)
        probe_stop = threading.Event()
        probe = collections.Counter()

        def probe_loop() -> None:
            c = Client(cl.master_url)
            rng = np.random.default_rng((seed, 99))
            pool = [x for v in full for x in by_vid[v]]
            while not probe_stop.is_set():
                fid, nid, size = pool[int(rng.integers(len(pool)))]
                vid = FileId.parse(fid).volume_id
                c._vid_cache.pop(vid)
                try:
                    urls = c.lookup(vid)
                    got = c.download(fid, url=urls[int(rng.integers(
                        len(urls)))])
                    probe["ok" if got == payload(seed, nid, size)
                          else "wrong bytes"] += 1
                except (ClientError, OSError) as e:
                    probe[f"failed: {str(e)[-40:]}"] += 1
                probe_stop.wait(0.05)

        probes = [threading.Thread(target=probe_loop, daemon=True)]
        for p in probes:
            p.start()
        # the skew is the balancer's to see from here
        lease.__exit__(None, None, None)
        t_skew = time.time()

        def moved() -> bool:
            st = client.balance_status()
            return st["moves_done"] >= 1 and not st["pending"]

        def balance_wait():
            try:
                wait_until(moved, "a completed balance move", timeout=300)
            except AssertionError:
                # what the balancer saw, for the report
                m = cl.master
                bal_log("balance.stuck", 300.0,
                        status=client.balance_status(),
                        plan=[mv.to_dict() for mv in balance_mod.plan_moves(
                            m.topology, m.balancer.cfg, time.time())],
                        daemon_jobs=sorted(map(str, m.daemon_jobs())),
                        holders={str(v): bal_holders(cl, v) for v in full},
                        racks={n.url: n.rack
                               for n in m.topology.nodes.values()})
                raise

        _, launches["balance.move"] = counted(balance_wait)
        status = client.balance_status()
        oks = [e for e in status["recent"] if e["outcome"] == "ok"]
        first_move_s = min(e["at"] for e in oks) - t_skew
        moved_vids = sorted({e["volume"] for e in oks})
        for e in oks:
            wait_until(lambda e=e: bal_holders(cl, e["volume"]).count(
                e["src"]) == 0 and e["dst"] in bal_holders(cl, e["volume"]),
                f"volume {e['volume']} on its new holder only")
        probe_stop.set()
        for p in probes:
            p.join()
        ran = shell_commands.run_command(env, "cluster.balance.run")
        # placement, EC, every needle from every new holder
        racks = {n.url: (n.data_center, n.rack)
                 for n in cl.master.topology.nodes.values()}
        for vid in full:
            h = bal_holders(cl, vid)
            if len(h) != 2 or len({racks[u] for u in h}) != 2:
                raise AssertionError(f"volume {vid} holders {h}")
        balance_daemon.plan_moves = plan_moves
        if any(cl.master.topology.lookup_ec_shards(v) for v in moved_vids):
            raise AssertionError("an EC volume moved")
        mid_heat = cl.master.topology.nodes[hot].heat.get(mid_vid)
        mid_rate = mid_heat.rate_now(time.time()) if mid_heat else 0.0
        if (any(mid_vid in p for p in plans) or mid_vid in moved_vids
                or bal_holders(cl, mid_vid) != holders[mid_vid]
                or not mid_rate):
            raise AssertionError(
                f"mid-encode volume {mid_vid}: planned "
                f"{sum(mid_vid in p for p in plans)} times, holders "
                f"{bal_holders(cl, mid_vid)}, rate {mid_rate}")
        # the shard set goes again: the volume is a normal one from here
        client.volume_admin(hot, "ec/delete_shards", {
            "volume_id": mid_vid, "collection": BAL_COLLECTION,
            "shard_ids": list(range(geometry.DEFAULT.total_shards))})
        wait_until(lambda: not cl.master.topology.lookup_ec_shards(
            mid_vid), "the mid-encode shards gone from the topology")
        bad_probe = {k: n for k, n in probe.items() if k != "ok"}
        if bad_probe or not probe["ok"]:
            raise AssertionError(f"reads during the moves: {dict(probe)}")
        t1 = time.perf_counter()
        new_reads, launches["balance.read_moved"] = counted(
            lambda: bal_read_procs(
                cl.master_url, [x for e in oks for x in by_vid[e["volume"]]],
                seed, {e["volume"]: e["dst"] for e in oks}))
        if new_reads["failed"]:
            raise AssertionError(f"moved volumes: "
                                 f"{dict(new_reads['failed'])}")
        rank = cl.master.balancer.assign_rank()
        new_fid = client.upload(b"n" * 4096, collection=BAL_NEW)
        new_holders = bal_holders(cl, FileId.parse(new_fid).volume_id)
        # the coldest node takes the new volume, the hottest never
        hottest = max(sorted(rank), key=rank.get)
        coldest = min(rank.values())
        if hottest in new_holders or \
                all(rank[u] > coldest for u in new_holders):
            raise AssertionError(f"assign placed {new_holders} on rank "
                                 f"{rank}")
        bal_log("balance.balancer", time.perf_counter() - t0,
                launches["balance.move"], hot_node=hot,
                hot_volumes=hot_vids, heat_reads=sum(reads.values()),
                rates_when_hot=hot_rates,
                seconds_to_hot=heat_s,
                seconds_lease_release_to_first_move=first_move_s,
                moves=len(oks), moved_volumes=moved_vids,
                mid_encode_volume=mid_vid, mid_encode_rate=mid_rate,
                passes_recorded=len(plans),
                mid_encode_launches=launches["balance.ec_mid_encode"],
                bytes_moved=status["moved_bytes"],
                recent=status["recent"][:4], probe_reads=dict(probe),
                moved_needles_read=len(new_reads["lat"]),
                moved_read_seconds=time.perf_counter() - t1,
                read_moved_launches=launches["balance.read_moved"],
                admin_lease_pending=lease_pending,
                passes_under_lease=under_lease["passes"],
                shell_balance_run=ran, assign_rank=rank,
                new_volume_holders=new_holders)

        # (11d) a balanced volume on the card: encode, degraded reads
        vid = oks[0]["volume"]
        t0 = time.perf_counter()
        _, launches["balance.ec_encode"] = counted(
            lambda: EcCommands(client, geometry.DEFAULT).encode(
                vid, BAL_COLLECTION))
        enc_s = time.perf_counter() - t0
        spread = ec_holders(client, vid)
        # a shard holder that is neither holder of the fifth volume, whose
        # pair the last step of 11b needs as it is
        gone = min((u for u in spread
                    if u not in (rep["holder"], rep["peer"])),
                   key=lambda u: (len(spread[u]), u))
        # the repair daemon paused while the needles are read, so every
        # read of a lost shard reconstructs; then it rebuilds them
        cl.master.repair_enabled = False
        cl.stop_volume_server(cl.index_of(gone))
        alive = sorted(u for u in spread if u != gone)
        t0 = time.perf_counter()
        m = cl.master.metrics
        heal0 = m.value("repairs_succeeded", labels={"kind": "ec"})

        sample = by_vid[vid][::BAL_DEGRADED_STRIDE]

        def degraded():
            t1 = time.perf_counter()
            out = bal_read_procs(cl.master_url, sample, seed,
                                 {vid: alive[0]})
            out["read_s"] = time.perf_counter() - t1
            cl.master.repair_enabled = True
            wait_until(lambda: m.value("repairs_succeeded",
                                       labels={"kind": "ec"}) > heal0,
                       "the repair daemon's rebuild", timeout=300)
            out["rebuild_s"] = time.perf_counter() - t1 - out["read_s"]
            return out

        deg, launches["balance.read_degraded"] = counted(degraded)
        if deg["failed"] or len(deg["lat"]) != len(sample):
            raise AssertionError(f"degraded reads {dict(deg['failed'])}")
        checked = 0
        for url in alive:
            base = os.path.join(cl.nodes[cl.index_of(url)][3],
                                f"{BAL_COLLECTION}_{vid}")
            stamped = pipeline.read_stamped_digests(base)
            sids = [s for s in range(geometry.DEFAULT.total_shards)
                    if os.path.exists(base + geometry.to_ext(s))]
            files = pipeline.shard_file_digest(base, sids).tolist()
            if [stamped.get(s) for s in sids] != files:
                raise AssertionError(f"{url}: .ecm {stamped} != {files}")
            checked += len(sids)
        bal_log("balance.ec_on_card", time.perf_counter() - t0 + enc_s,
                {k: launches[k] for k in BALANCE_CODER_STEPS},
                volume=vid, encode_s=enc_s, spread=spread,
                stopped=gone, reads=len(deg["lat"]), bytes=deg["bytes"],
                read_s=deg["read_s"], rebuild_after_reads_s=deg["rebuild_s"],
                **{k: v for k, v in latency_summary(deg["lat"]).items()
                   if k != "reads"}, ecm_shards_checked=checked)

        # (11b, last) the peer down: a corrupt needle answers 500 at once
        def no_peer():
            # the repair daemon off: a fresh copy of the volume elsewhere
            # would give the holder a live peer again
            cl.master.repair_enabled = False
            a, b = sorted(bal_holders(cl, rep["volume"]),
                          key=lambda u: u != rep["holder"])
            cl.stop_volume_server(cl.index_of(b))
            fid = by_vid[rep["volume"]][2][0]
            flip_needle_byte(cl, a, rep["volume"], fid)
            times = []
            for _ in range(8):
                t0 = time.perf_counter()
                r = http.request("GET", f"http://{a}/{fid}", timeout=60)
                times.append(time.perf_counter() - t0)
                if r.status != 500 or b"data corruption" not in r.data:
                    raise AssertionError(f"{r.status} {r.data[:80]!r}")
            if max(times) > BAL_FAST_500_S:
                raise AssertionError(f"500 after {max(times)} s")
            return times

        times, launches["balance.read_no_peer"] = counted(no_peer)
        bal_log("balance.read_no_peer", sum(times),
                launches["balance.read_no_peer"], reads=len(times),
                max_s=max(times), bound_s=BAL_FAST_500_S)
    finally:
        cl.shutdown()
    shutil.rmtree(work / "cluster", ignore_errors=True)

    # (11e) the crash sweep of group commit, and clustersim at 1000 nodes
    t0 = time.perf_counter()
    summary, launches["balance.crash"] = counted(
        lambda: crash_harness.sweep_all(
            seeds=CRASH_SEEDS, points=CRASH_POINTS,
            workloads=[crash_wl.make_group_commit_workload()],
            scratch_dir=str(work)))
    bal_log("balance.crash_group_commit", time.perf_counter() - t0,
            launches["balance.crash"], points=summary["total_points"],
            violations=summary["total_violations"])
    if not summary["ok"] or summary["total_points"] != \
            CRASH_SEEDS * CRASH_POINTS:
        raise AssertionError(f"group-commit sweep: {summary}")
    t0 = time.perf_counter()
    reports, launches["balance.clustersim"] = counted(
        lambda: [sim_scenarios.run_scenario(name, 0, nodes=sim_nodes)
                 for name in sim_scenarios.SCENARIOS])
    bal_log("balance.clustersim", time.perf_counter() - t0,
            launches["balance.clustersim"], nodes=sim_nodes,
            digests={r["scenario"]: r["digest"] for r in reports},
            moves={r["scenario"]: r["moves"] for r in reports},
            repairs={r["scenario"]: r["repairs"] for r in reports})
    bad = {r["scenario"]: r["violations"] for r in reports
           if r["violations"]}
    if bad:
        raise AssertionError(f"clustersim violations {bad}")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def check_balance_launches(launches: dict) -> None:
    """gf_apply in 11d's steps, nothing in any other step of the phase,
    no other kernel anywhere."""
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in BALANCE_CODER_STEPS) != (counts["gf_apply"]
                                                       > 0):
            raise AssertionError(f"{step}: launches {counts}")


# --- phase 12: the rest of the storage engine ----------------------------

STOR_MAX_NEEDLE = 16 * 1024   # phase 3's generator, log-uniform 1-16 KiB
# 12a's volume (1 GiB, and 12b's 256 MiB, before phase 14, then 768
# MiB, then 640 MiB before phase 18; 12a keeps more than FLUSH_THRESHOLD
# needles, about 108k, so its map flushes)
STOR_DISK_BYTES = 576 * MIB
STOR_FUSED_BYTES = 128 * MIB  # 12b's archive volume
# 12c's uploads, and its vacuumed volume (cut from 64 MiB for phase 13,
# from 32 MiB for phase 15)
STOR_UPLOAD_BYTES = 16 * MIB
STOR_MORE, STOR_MORE_DELETES = 500, 100
STOR_READ_STRIDE = 16         # 12a's reads, healthy and degraded
STOR_EC_READ_STRIDE = 8       # 12c's degraded reads
STOR_THREADS = 8              # 12c's HTTP clients
STOR_VACUUM_SLOWDOWN = 2.0    # the throttled copy's plan, in free copies
STOR_COLLECTION = "storsmoke"
# steps of phase 12 that run the coder (gf_apply must launch there, and
# in no other step of the phase)
STORAGE_CODER_STEPS = ("storage.ec_generate", "storage.ec_generate_memory",
                       "storage.read_degraded", "storage.fused_generate",
                       "storage.fused_generate_memory",
                       "storage.cluster_ec_encode",
                       "storage.cluster_read_degraded",
                       "storage.d9_ec_generate")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024
    return float("nan")


def map_triples(directory: str, collection: str, vid: int,
                kind: str) -> tuple:
    """Open the volume under `kind`; its (key, offset, size) set, the map,
    the open's seconds and its RSS growth."""
    import gc
    gc.collect()
    before = rss_mb()
    t0 = time.perf_counter()
    v = Volume(directory, collection, vid, needle_map_kind=kind)
    secs = time.perf_counter() - t0
    grown = rss_mb() - before
    try:
        triples = sorted((nv.key, nv.offset, nv.size)
                         for nv in v.nm.values())
        info = {"kind": kind, "open_s": secs, "rss_growth_mb": grown,
                "map": type(v.nm).__name__,
                "adopted": getattr(v.nm, "adopted", None),
                "replayed": getattr(v.nm, "replayed", None)}
    finally:
        v.close()
    return triples, info


def read_stride(reader, sizes: dict, deleted: set, seed: int,
                stride: int) -> dict:
    """read_all over the first needle and every `stride`-th after it."""
    ids = sorted(sizes)[::stride]
    return read_all(reader, {n: sizes[n] for n in ids}, deleted, seed)


def copy_volume(src_base: str, dst_dir: Path, name: str) -> str:
    dst_dir.mkdir(parents=True, exist_ok=True)
    dst = str(dst_dir / name)
    for ext in (".dat", ".idx"):
        shutil.copyfile(src_base + ext, dst + ext)
    return dst


def run_storage_disk_map(work: Path, coder_name: str, device,
                         total: int, launches: dict) -> None:
    """(12a) A volume under needle_map_kind="leveldb" through the Store:
    write, flushes, reopen (the .sdx adopted), the map kinds agree, reads,
    ec_generate on the card against a "memory" copy's, degraded reads."""
    seed = SEED + 13
    directory = str(work / "disk")
    base = os.path.join(directory, "1")
    st = store_mod.Store([directory], coder_name=coder_name, device=device,
                         needle_map_kind="leveldb")
    try:
        vol = st.add_volume(1)
        (sizes, deleted), launches["storage.write_volume"] = counted(
            lambda: timed(
                "storage.write_volume",
                lambda: write_needles(
                    lambda n: st.write_needle(1, n),
                    lambda n: st.delete_needle(1, n), vol.data_file_size,
                    total, STOR_MAX_NEEDLE, seed),
                lambda r: vol.data_file_size(),
                lambda r: {"needles": len(r[0]), "deleted": len(r[1]),
                           "flushes": vol.nm.flushes,
                           "delta_entries": len(vol.nm._map),
                           "segment_entries": vol.nm._count}))
        flushes = vol.nm.flushes
        # at least one merge for each FLUSH_THRESHOLD needles written
        if flushes < len(sizes) // DiskNeedleMap.FLUSH_THRESHOLD:
            raise AssertionError(f"the disk map flushed {flushes} times")
    finally:
        st.close()
    sdx_bytes = os.path.getsize(base + ".sdx")
    kinds, infos = {}, {}
    for kind in ("leveldb", "memory", "compact"):
        kinds[kind], infos[kind] = map_triples(directory, "", 1, kind)
    if not infos["leveldb"]["adopted"] or \
            infos["leveldb"]["replayed"] >= DiskNeedleMap.FLUSH_THRESHOLD:
        raise AssertionError(f"the reopen did not adopt the .sdx: "
                             f"{infos['leveldb']}")
    if not kinds["leveldb"] == kinds["memory"] == kinds["compact"]:
        raise AssertionError("the map kinds disagree on (key, offset, size)")
    bal_log("storage.maps", 0.0, flushes=flushes, sdx_bytes=sdx_bytes,
            entries=len(kinds["memory"]), opens=infos,
            triples_equal=True)
    st = store_mod.Store([directory], coder_name=coder_name, device=device,
                         needle_map_kind="leveldb")
    try:
        reader = StoreReader(st, 1)
        _, launches["storage.read"] = counted(lambda: timed(
            "storage.read", lambda: read_stride(
                reader, sizes, deleted, seed, STOR_READ_STRIDE),
            lambda r: r["bytes"],
            lambda r: latency_summary(r["latencies"])))
        st.find_volume(1).seal()
        mem = copy_volume(base, work / "disk_memory", "1")
        g = st.geometry_for("")
        dat_size = os.path.getsize(base + ".dat")
        _, launches["storage.ec_generate"] = counted(lambda: timed(
            "storage.ec_generate", lambda: st.ec_generate(1),
            lambda r: dat_size))
        check_ecm_digests(base, g, "storage.ec_generate")
        sha = shard_shas(base, g)
    finally:
        st.close()
    mst = store_mod.Store([os.path.dirname(mem)], coder_name=coder_name,
                          device=device, needle_map_kind="memory")
    try:
        _, launches["storage.ec_generate_memory"] = counted(lambda: timed(
            "storage.ec_generate_memory", lambda: mst.ec_generate(1),
            lambda r: dat_size))
    finally:
        mst.close()
    if shard_shas(mem, g) != sha or \
            sha256_file(mem + ".ecx") != sha256_file(base + ".ecx"):
        raise AssertionError("shards of the leveldb volume differ from the "
                             "memory copy's")
    shutil.rmtree(work / "disk_memory", ignore_errors=True)
    # the shards take over; a reopen finds the EC volume
    os.remove(base + ".dat")
    st = store_mod.Store([directory], coder_name=coder_name, device=device,
                         needle_map_kind="leveldb")
    try:
        ev = st.find_ec_volume(1)
        if st.find_volume(1) is not None or ev is None:
            raise AssertionError("the reopen did not find the EC volume")
        st.ec_delete_shards(1, "", list(VICTIMS))
        on_victims = needles_on(ev, {n: 0 for n in sorted(sizes)[
            ::STOR_READ_STRIDE]}, deleted, VICTIMS)
        reader = StoreReader(st, 1)
        _, launches["storage.read_degraded"] = counted(lambda: timed(
            "storage.read_degraded", lambda: read_stride(
                reader, sizes, deleted, seed, STOR_READ_STRIDE),
            lambda r: r["bytes"],
            lambda r: {"needles_on_victims": on_victims,
                       **latency_summary(r["latencies"])}))
    finally:
        st.close()
    bal_log("storage.disk_summary", 0.0, needles=len(sizes),
            deleted=len(deleted), dat_bytes=dat_size, flushes=flushes,
            sdx_bytes=sdx_bytes, shards_sha256_equal_memory=True,
            needles_on_victims=on_victims)
    shutil.rmtree(work / "disk", ignore_errors=True)


def run_storage_fused(work: Path, coder_name: str, device, total: int,
                      launches: dict) -> None:
    """(12b) The archive collection's RS(20,4) fused warm-down of a
    leveldb volume whose tombstones sit in the delta over segment
    entries, against a "memory" copy's."""
    seed = SEED + 14
    directory = str(work / "fused")
    base = os.path.join(directory, "archive_2")
    st = store_mod.Store([directory], coder_name=coder_name, device=device,
                         needle_map_kind="leveldb")
    try:
        vol = st.add_volume(2, collection="archive")

        def fill() -> int:
            nid = 0
            while vol.data_file_size() < total:
                nid += 1
                st.write_needle(2, archive_needle(seed, nid))
            return nid

        count, launches["storage.fused_write"] = counted(lambda: timed(
            "storage.fused_write", fill, lambda r: vol.data_file_size(),
            lambda r: {"needles": r}))
    finally:
        st.close()     # the delta lands in the .sdx
    st = store_mod.Store([directory], coder_name=coder_name, device=device,
                         needle_map_kind="leveldb")
    try:
        vol = st.find_volume(2)
        if not vol.nm.adopted or vol.nm._count != count:
            raise AssertionError(f"archive reopen: adopted "
                                 f"{vol.nm.adopted}, segment {vol.nm._count}")
        rng = np.random.default_rng(seed)
        gone = {int(i) + 1 for i in rng.choice(count, size=int(0.3 * count),
                                               replace=False)}
        for d in sorted(gone):
            st.delete_needle(2, Needle(cookie=d * 7919 & 0xFFFFFFFF, id=d))
        delta_tombstones = sum(1 for nv in vol.nm._map.values()
                               if nv.size < 0)
        if delta_tombstones != len(gone) or vol.nm._count != count:
            raise AssertionError(f"{delta_tombstones} tombstones in the "
                                 f"delta for {len(gone)} deletes")
        vol.sync()
        mem = copy_volume(base, work / "fused_memory", "archive_2")
        g = st.geometry_for("archive")
        src_bytes = vol.data_file_size()
        _, launches["storage.fused_generate"] = counted(lambda: timed(
            "storage.fused_generate", lambda: st.ec_fused_generate(2),
            lambda r: src_bytes,
            lambda r: {"delta_tombstones": delta_tombstones}))
        check_ecm_digests(base, g, "storage.fused_generate")
    finally:
        st.close()
    mst = store_mod.Store([os.path.dirname(mem)], coder_name=coder_name,
                          device=device, needle_map_kind="memory")
    try:
        _, launches["storage.fused_generate_memory"] = counted(
            lambda: timed("storage.fused_generate_memory",
                          lambda: mst.ec_fused_generate(2),
                          lambda r: src_bytes))
    finally:
        mst.close()
    if shard_shas(mem, g) != shard_shas(base, g):
        raise AssertionError("fused shards differ from the memory copy's")
    dats = []
    for b in (base, mem):
        with open(b + ".ecm") as f:
            dat_size = json.load(f)["dat_size"]
        dec = b + ".decoded"
        for i in range(g.data_shards):
            os.link(b + geometry.to_ext(i), dec + geometry.to_ext(i))
        striping.write_dat_file(dec, dat_size, g)
        dats.append(sha256_file(dec + ".dat"))
    if dats[0] != dats[1]:
        raise AssertionError("compacted .dat differs from the memory copy's")
    bal_log("storage.fused_summary", 0.0, needles=count,
            deleted=len(gone), src_bytes=src_bytes,
            compacted_bytes=dat_size, delta_tombstones=delta_tombstones,
            shards_sha256_equal_memory=True,
            compacted_dat_sha256_equal_memory=True)
    shutil.rmtree(work / "fused", ignore_errors=True)
    shutil.rmtree(work / "fused_memory", ignore_errors=True)


def stor_upload(master_url: str, collection: str, seed: int, first: int,
                count: int = 0, total: int = 0,
                threads: int = STOR_THREADS) -> dict:
    """Needles of phase 3's generator (log-uniform 1-16 KiB, sized by
    their id) uploaded over HTTP by `threads` clients, ids from `first`,
    until `count` needles or `total` bytes; fid -> (nid, size)."""
    ids = itertools.count(first)
    lock = threading.Lock()
    out: dict = {}
    sent = [0, 0]
    errors: list = []

    def size_of(nid: int) -> int:
        rng = np.random.default_rng((seed, nid, 1))
        return int(np.exp(rng.uniform(np.log(1024),
                                      np.log(STOR_MAX_NEEDLE))))

    def worker() -> None:
        client = Client(master_url)
        try:
            while True:
                with lock:
                    if (count and sent[0] >= count) or \
                            (total and sent[1] >= total):
                        return
                    nid = next(ids)
                    size = size_of(nid)
                    sent[0] += 1
                    sent[1] += size
                fid = client.upload(payload(seed, nid, size),
                                    collection=collection)
                with lock:
                    out[fid] = (nid, size)
        except Exception as e:
            errors.append(e)

    ths = [threading.Thread(target=worker) for _ in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errors:
        raise errors[0]
    return out


def stor_read(master_url: str, fids: dict, deleted: set, seed: int,
              threads: int = STOR_THREADS) -> dict:
    """Every fid read over HTTP by `threads` clients: live ones equal to
    their payload, deleted ones 404. Returns bytes and latencies."""
    items = sorted(fids.items())
    lat: list = []
    nbytes = [0]
    lock = threading.Lock()
    errors: list = []

    def part(chunk) -> None:
        client = Client(master_url)
        try:
            for fid, (nid, size) in chunk:
                if fid in deleted:
                    try:
                        client.download(fid)
                    except ClientError as e:
                        if "HTTP 404" not in str(e):
                            raise
                        continue
                    raise AssertionError(f"deleted {fid} still readable")
                t0 = time.perf_counter()
                data = client.download(fid)
                dt = time.perf_counter() - t0
                if data != payload(seed, nid, size):
                    raise AssertionError(f"needle {fid} reads back wrong")
                with lock:
                    lat.append(dt)
                    nbytes[0] += size
        except Exception as e:
            errors.append(e)

    ths = [threading.Thread(target=part, args=(items[i::threads],))
           for i in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    if errors:
        raise errors[0]
    return {"bytes": nbytes[0], "latencies": lat}


def run_cli_json(*argv) -> dict:
    """One CLI command through the port's entry point, in this process;
    its last stdout line as JSON."""
    import contextlib
    import io

    from seaweedfs_torch import cli as cli_mod
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_mod.main(list(argv))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def backup_live(directory: str, collection: str, vid: int) -> dict:
    v = Volume(directory, collection, vid)
    try:
        return {k: v.read_needle(k).data for k, _ in v.nm.live_entries()}
    finally:
        v.close()


def run_storage_cluster(work: Path, coder_name: str, device,
                        upload_bytes: int, launches: dict) -> None:
    """(12c) Two volume servers at -index leveldb: uploads, CLI backup
    twice and fix, tier upload / restart / download through the shell,
    ec.encode on the card and degraded reads, the watchdog (and D9), a
    vacuum at a byte rate with reads during it."""
    seed = SEED + 15
    col = STOR_COLLECTION
    cl = LocalCluster(2, coder_name=coder_name, device=device,
                      volume_size_limit_mb=1024, pulse=0.5,
                      directory=str(work / "cluster"), racks=1,
                      master_kwargs={"repair_enabled": False},
                      volume_kwargs={"scrub_interval_seconds": 0},
                      store_kwargs={"needle_map_kind": "leveldb"})
    try:
        client = Client(cl.master_url)
        env = shell_commands.CommandEnv(client, geometry.DEFAULT)
        shell_commands._register_all()
        vid = client.grow(count=1, collection=col)["volume_ids"][0]
        holder = cl.index_of(client.lookup(vid)[0])

        # (12c.1) the uploads, then 5% deleted
        def upload() -> tuple:
            fids = stor_upload(cl.master_url, col, seed, 1,
                               total=upload_bytes)
            rng = np.random.default_rng(seed)
            gone = {str(f) for f in rng.choice(
                sorted(fids), size=len(fids) // 20, replace=False)}
            for fid in sorted(gone):
                client.delete(fid)
            return fids, gone

        (fids, deleted), launches["storage.upload"] = counted(
            lambda: timed("storage.upload", upload,
                          lambda r: sum(s for _, s in r[0].values()),
                          lambda r: {"needles": len(r[0]),
                                     "deleted": len(r[1])}))
        if {FileId.parse(f).volume_id for f in fids} != {vid}:
            raise AssertionError("uploads spread over volumes")

        # (12c.2) CLI backup, then 500 uploads and 100 deletes, again
        bdir = str(work / "backup")
        bargs = ("backup", "-server", cl.master_url, "-dir", bdir,
                 "-collection", col, "-volumeId", str(vid))
        first, launches["storage.backup"] = counted(lambda: timed(
            "storage.backup", lambda: run_cli_json(*bargs),
            extra=lambda r: r))
        if first["applied"] != len(fids) + len(deleted):
            raise AssertionError(f"backup applied {first}")
        more = stor_upload(cl.master_url, col, seed, 10**6,
                           count=STOR_MORE)
        rng = np.random.default_rng(seed + 1)
        live_old = sorted(f for f in fids if f not in deleted)
        gone = {str(f) for f in rng.choice(live_old, size=STOR_MORE_DELETES,
                                           replace=False)}
        for fid in sorted(gone):
            client.delete(fid)
        fids.update(more)
        deleted |= gone
        second, launches["storage.backup_incremental"] = counted(
            lambda: timed("storage.backup_incremental",
                          lambda: run_cli_json(*bargs), extra=lambda r: r))
        if second["applied"] != STOR_MORE + STOR_MORE_DELETES:
            raise AssertionError(f"incremental backup applied {second}")
        src = cl.store(holder).find_volume(vid)
        want = {k: src.read_needle(k).data for k, _ in
                src.nm.live_entries()}
        if backup_live(bdir, col, vid) != want:
            raise AssertionError("the backup's live needles differ")
        os.remove(os.path.join(bdir, f"{col}_{vid}.idx"))
        fixed, launches["storage.fix"] = counted(lambda: timed(
            "storage.fix", lambda: run_cli_json(
                "fix", "-dir", bdir, "-collection", col, "-volumeId",
                str(vid)), extra=lambda r: r))
        if backup_live(bdir, col, vid) != want:
            raise AssertionError("the live set after fix differs")
        shutil.rmtree(bdir, ignore_errors=True)

        # (12c.3) the shell's tier upload: reads through RemoteFile
        bucket = str(work / "bucket")
        _, launches["storage.tier_upload"] = counted(lambda: timed(
            "storage.tier_upload", lambda: shell_commands.run_command(
                env, ["volume.tier.upload", "-volumeId", str(vid), "-dest",
                      f"local_store:{bucket}"]),
            lambda r: os.path.getsize(os.path.join(
                bucket, f"{col}_{vid}.dat"))))
        v = cl.store(holder).find_volume(vid)
        if not v.is_remote or os.path.exists(v.base_file_name() + ".dat"):
            raise AssertionError("the tiered volume kept its local .dat")

        def read_step(name: str, **extra) -> None:
            client._vid_cache.clear()
            _, launches[name] = counted(lambda: timed(
                name, lambda: stor_read(cl.master_url, fids, deleted, seed),
                lambda r: r["bytes"],
                lambda r: {**extra, **latency_summary(r["latencies"])}))

        read_step("storage.read_tiered", remote=True)
        # (12c.4) the holder restarts: tiered again from its .vif
        timed("storage.restart_holder",
              lambda: cl.restart_volume_server(holder))
        cl.wait_for_nodes(2)
        if not cl.store(holder).find_volume(vid).is_remote:
            raise AssertionError("the restarted volume is not tiered")
        read_step("storage.read_tiered_restarted", remote=True)
        # (12c.5) download, ec.encode on the card, degraded reads
        _, launches["storage.tier_download"] = counted(lambda: timed(
            "storage.tier_download", lambda: shell_commands.run_command(
                env, ["volume.tier.download", "-volumeId", str(vid)])))
        if cl.store(holder).find_volume(vid).is_remote:
            raise AssertionError("the download left the volume tiered")
        _, launches["storage.cluster_ec_encode"] = counted(lambda: timed(
            "storage.cluster_ec_encode", lambda: shell_commands.run_command(
                env, ["ec.encode", "-volumeId", str(vid), "-collection",
                      col])))
        info = client.ec_lookup(vid)
        if len(info["shards"]) != 14:
            raise AssertionError(f"ec.encode mounted {info}")
        for sid in VICTIMS:
            for url in info["shards"][str(sid)]:
                client.volume_admin(url, "ec/delete_shards",
                                    {"volume_id": vid, "collection": col,
                                     "shard_ids": [sid]})
        sample = dict(sorted(fids.items())[::STOR_EC_READ_STRIDE])
        client._vid_cache.clear()
        _, launches["storage.cluster_read_degraded"] = counted(
            lambda: timed("storage.cluster_read_degraded",
                          lambda: stor_read(cl.master_url, sample, deleted,
                                            seed),
                          lambda r: r["bytes"],
                          lambda r: {"lost": list(VICTIMS),
                                     **latency_summary(r["latencies"])}))

        # (12c.6) the watchdog on one server, D9 there
        launches.update(run_storage_watchdog(cl, client, seed))
        # (12c.7) a vacuum at a byte rate, reads during it
        launches.update(run_storage_vacuum(cl, client, seed,
                                           upload_bytes))
    finally:
        cl.shutdown()
    shutil.rmtree(work / "cluster", ignore_errors=True)
    shutil.rmtree(work / "bucket", ignore_errors=True)


def fill_store_volume(st, vid: int, collection: str, total: int,
                      seed: int) -> tuple:
    """Phase 3's generator at 1-16 KiB written into a server's Store
    directly (the volume server reports it at its next beat)."""
    v = st.add_volume(vid, collection=collection)
    sizes, _ = write_needles(lambda n: st.write_needle(vid, n),
                             lambda n: None, v.data_file_size, total,
                             STOR_MAX_NEEDLE, seed)
    return sizes


def run_storage_watchdog(cl, client, seed: int) -> dict:
    """(12c.6) min_free_space_percent=101 on server 0 seals its writable
    volumes; uploads go to server 1; an operator's seal and D9's sequence
    (a watchdog-sealed volume then ec-generated) stay sealed when the
    threshold is back at 0, and only the watchdog's own seal lifts."""
    launches = {}
    col = "stor_wd"
    st_a, st_b = cl.store(0), cl.store(1)
    base_vid = 9000
    w, o, e, b = base_vid, base_vid + 1, base_vid + 2, base_vid + 3
    for st, vid in ((st_a, w), (st_a, o), (st_a, e), (st_b, b)):
        fill_store_volume(st, vid, col, 2 * MIB, seed + vid)
    client.volume_admin(cl.url(0), "volume/readonly",
                        {"volume_id": o, "read_only": True})
    # the master knows all four (the grown vids come after them), B's
    # writable, before the threshold moves
    wait_until(lambda: {v["id"]: v["read_only"] for nd in
                        client.dir_status()["nodes"] for v in nd["volumes"]
                        if v["id"] >= base_vid} == {
        w: False, o: True, e: False, b: False}, "the four volumes' beats",
        timeout=30)
    t0 = time.perf_counter()
    st_a.min_free_space_percent = 101.0
    wait_until(lambda: st_a.find_volume(w).read_only
               and st_a.find_volume(e).read_only, "the watchdog's seal",
               timeout=30)
    seal_s = time.perf_counter() - t0
    vols = {vid: st_a.find_volume(vid) for vid in (w, o, e)}
    if not (vols[w].watchdog_sealed and vols[e].watchdog_sealed
            and not vols[o].watchdog_sealed):
        raise AssertionError("the watchdog sealed what it must not")
    # the master sees the seals at the next beat: then uploads go to B
    wait_until(lambda: all(
        v["read_only"] for nd in client.dir_status()["nodes"]
        if nd["url"] == cl.url(0) for v in nd["volumes"]
        if v["id"] in (w, e)), "the sealed beat", timeout=30)
    ups = stor_upload(cl.master_url, col, seed, 5 * 10**6, count=40,
                      threads=2)
    where = {FileId.parse(f).volume_id for f in ups}
    on_a = {vid for vid in where if st_a.find_volume(vid) is not None}
    if on_a:
        raise AssertionError(f"uploads landed on the low server: {on_a}")
    # D9: the watchdog-sealed volume is ec-generated, then space is back
    _, launches["storage.d9_ec_generate"] = counted(
        lambda: client.volume_admin(cl.url(0), "ec/generate",
                                    {"volume_id": e, "collection": col}))
    st_a.min_free_space_percent = 0.0
    t0 = time.perf_counter()
    wait_until(lambda: not st_a.find_volume(w).read_only,
               "the watchdog's lift", timeout=30)
    lift_s = time.perf_counter() - t0
    time.sleep(2 * cl.pulse)
    states = {vid: st_a.find_volume(vid).read_only for vid in (w, o, e)}
    if states != {w: False, o: True, e: True}:
        raise AssertionError(f"after the lift: {states}")
    bal_log("storage.watchdog", seal_s + lift_s,
            launches["storage.d9_ec_generate"], seal_s=seal_s,
            lift_s=lift_s, uploads_while_low=len(ups),
            upload_volumes=sorted(where),
            read_only_after_lift={"watchdog": states[w],
                                  "operator": states[o],
                                  "d9_ec_generated": states[e]})
    return launches


def run_storage_vacuum(cl, client, seed: int, total: int) -> dict:
    """(12c.7) /admin/vacuum/compact with compaction_byte_per_second on a
    volume 30% deleted, HTTP reads of it from 4 clients during the copy.
    The rate is planned from a copy at no rate (cleaned up after) so that
    the throttled copy must take STOR_VACUUM_SLOWDOWN times as long: it
    takes at least its bytes over the rate, which a copy that never
    sleeps would not, and no read waits 1 s."""
    launches = {}
    col, vid = "stor_vac", 9100
    st = cl.store(1)
    sizes = fill_store_volume(st, vid, col, total, seed + 7)
    rng = np.random.default_rng(seed + 7)
    gone = {int(i) for i in rng.choice(sorted(sizes), size=int(
        0.3 * len(sizes)), replace=False)}
    for nid in sorted(gone):
        st.delete_needle(vid, Needle(cookie=nid * 7919 & 0xFFFFFFFF,
                                     id=nid))
    live = sorted(n for n in sizes if n not in gone)
    live_bytes = sum(st_types.get_actual_size(sizes[n], 3) for n in live)
    url = cl.url(1)
    base = st.find_volume(vid).base_file_name()
    wait_until(lambda: any(v["id"] == vid for nd in
                           client.dir_status()["nodes"]
                           for v in nd["volumes"]), "the vacuum volume")
    stop = threading.Event()
    lat: list = []
    errors: list = []

    def reader(i: int) -> None:
        c = Client(cl.master_url)
        k = i
        try:
            while not stop.is_set():
                nid = live[k % len(live)]
                fid = str(FileId(vid, nid, nid * 7919 & 0xFFFFFFFF))
                t0 = time.perf_counter()
                data = c.download(fid, url=url)
                lat.append(time.perf_counter() - t0)
                if data != payload(seed + 7, nid, sizes[nid]):
                    raise AssertionError(f"{fid} reads back wrong")
                k += 4
        except Exception as e:
            errors.append(e)

    ths = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for th in ths:
        th.start()
    try:
        def compact(rate: int):
            client.volume_admin(url, "vacuum/compact",
                                {"volume_id": vid,
                                 "compaction_byte_per_second": rate})
            return os.path.getsize(base + ".cpd")

        t0 = time.perf_counter()
        _, launches["storage.vacuum_free"] = counted(lambda: compact(0))
        wall_free = time.perf_counter() - t0
        client.volume_admin(url, "vacuum/cleanup", {"volume_id": vid})
        rate = int(live_bytes / (STOR_VACUUM_SLOWDOWN * wall_free))
        t0 = time.perf_counter()
        cpd, launches["storage.vacuum_throttled"] = counted(
            lambda: compact(rate))
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        for th in ths:
            th.join()
    if errors:
        raise errors[0]
    client.volume_admin(url, "vacuum/commit", {"volume_id": vid})
    copied = cpd - 8
    worst = max(lat)
    if wall < copied / rate or worst >= 1.0:
        raise AssertionError(f"throttled vacuum {wall:.3f} s for {copied} "
                             f"bytes at {rate} B/s (at no rate "
                             f"{wall_free:.3f} s), slowest read "
                             f"{worst:.3f} s")
    after = {n: sizes[n] for n in live[::STOR_EC_READ_STRIDE]}
    reader_v = StoreReader(st, vid)
    read_all(reader_v, after, set(), seed + 7)
    bal_log("storage.vacuum_throttled", wall,
            launches["storage.vacuum_throttled"], rate_bps=rate,
            copied_bytes=copied, floor_s=copied / rate,
            free_copy_s=wall_free, slowdown=wall / wall_free,
            reads_during=len(lat), **{"read_" + k: v for k, v in
                                      latency_summary(lat).items()},
            garbage_before=0.3)
    return launches


def run_storage_crash(work: Path, launches: dict,
                      points: int = MESH_CRASH_POINTS) -> None:
    """(12d) needle_map_flush at CRASH_SEEDS x `points`: 0 violations."""
    t0 = time.perf_counter()
    w = crash_wl.make_needle_map_workload()
    summary, launches["crash.needle_map_flush"] = counted(
        lambda: crash_harness.sweep_all(seeds=CRASH_SEEDS, points=points,
                                        workloads=[w],
                                        scratch_dir=str(work)))
    runs = summary["workloads"][w.name]
    bal_log("crash.needle_map_flush", time.perf_counter() - t0,
            launches["crash.needle_map_flush"],
            points=summary["total_points"],
            violations=summary["total_violations"],
            ops=[r["ops"] for r in runs])
    if not summary["ok"] or summary["total_points"] != CRASH_SEEDS * points:
        raise AssertionError(f"crash sweep needle_map_flush: {summary}")


def check_storage_launches(launches: dict) -> None:
    """gf_apply in the coder steps of phase 12 and nowhere else in it,
    no other kernel anywhere."""
    for step, counts in launches.items():
        others = {k: n for k, n in counts.items() if k != "gf_apply" and n}
        if others or (step in STORAGE_CODER_STEPS) != (counts["gf_apply"]
                                                       > 0):
            raise AssertionError(f"{step}: launches {counts}")


def run_storage(work: Path, coder_name: str = "auto", device=None,
                disk_bytes: int = STOR_DISK_BYTES,
                fused_bytes: int = STOR_FUSED_BYTES,
                upload_bytes: int = STOR_UPLOAD_BYTES) -> dict:
    """Phase 12; returns launches per step. On the card the launches are
    held to the phase's rule; ``coder_name="torch", device="cpu"`` at a
    few MB runs it on a host without one (no launch is counted there)."""
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    observe.reset()
    governor.reset()
    launches: dict = {}
    run_storage_disk_map(work, coder_name, device, disk_bytes, launches)
    run_storage_fused(work, coder_name, device, fused_bytes, launches)
    run_storage_cluster(work, coder_name, device, upload_bytes, launches)
    run_storage_crash(work / "crash", launches)
    if coder_name == "auto":
        check_storage_launches(launches)
    bal_log("storage.summary", time.perf_counter() - t0, launches)
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 13: HA masters -------------------------------------------------

HA_COLLECTION = "hasmoke"
HA_LIMIT_MB = 160         # the phase's volume size limit (256 before
#                           phase 20)
HA_CLIENTS = 16           # upload clients (threads), in HA_PROCS processes
HA_PROCS = 4
HA_MAX_NEEDLE = 4 * MIB   # phase 3's generator: log-uniform 1 KiB .. 4 MiB
HA_ASSIGNS = 2000         # the assign stream's calls, round-robin
HA_KILL_AT = 1000         # the leader stops once the stream made these,
#                           or once the volume is half full
HA_PULSE = 0.5
HA_CATCH_UP_S = 10.0      # the restarted master's bound to equal captures
HA_READERS = 4            # 13d's HTTP reader threads
# steps of phase 13 that run the coder (gf_apply must launch there, and
# in no other step of the phase)
HA_CODER_STEPS = ("ha.ec_encode", "ha.read_degraded", "ha.rebuild")


def _ha_upload_proc(master_url: str, collection: str, seed: int,
                    first_nid: int, threads: int, max_needle: int, stop,
                    out) -> None:
    """One uploader process: `threads` clients, each a ``Client`` over the
    masters' list, assign one key and upload one of phase 3's needles
    until `stop`; an assign refused or unanswered (a failover) is retried
    every 0.05 s for up to 30 s. Puts (acked [(fid, nid, size)], assigned
    [(key, 1)], assign latencies, the longest assign wait, errors) on
    `out`."""
    lock = threading.Lock()
    acked, assigned, lat, errors = [], [], [], []
    nids = itertools.count(first_nid)

    def loop(i: int) -> None:
        client = Client(master_url)
        rng = np.random.default_rng((seed, first_nid, i))
        while not stop.is_set():
            t0 = time.perf_counter()
            while True:
                try:
                    a = client.assign(collection=collection)
                    break
                except (ClientError, OSError) as e:
                    if time.perf_counter() - t0 > 30:
                        errors.append(f"assign: {e!r}")
                        return
                    time.sleep(0.05)
            dt = time.perf_counter() - t0
            with lock:
                nid = next(nids)
                assigned.append((FileId.parse(a["fid"]).key, 1))
                lat.append(dt)
            size = int(np.exp(rng.uniform(np.log(1024),
                                          np.log(max_needle))))
            try:
                client.upload_blob(a["url"], a["fid"],
                                   payload(seed, nid, size))
            except (ClientError, OSError) as e:
                errors.append(f"upload {a['fid']}: {e!r}")
                return
            with lock:
                acked.append((a["fid"], nid, size))

    workers = [threading.Thread(target=loop, args=(i,), daemon=True)
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out.put((acked, assigned, lat, max(lat, default=0.0), errors))


def ha_assign_stream(cl, n: int, kill_at: int, reached: threading.Event,
                     rows: list) -> None:
    """`n` GET /dir/assign?count=1..16 round-robin over the three
    masters, one at a time. A refused call (a follower with no leader, a
    leader mid-election) is sent again to the same master every 0.02 s,
    for up to 10 s; a master that is down (its connection refused) is
    passed over. Each try is a row: (monotonic end, the target's role
    when sent, HTTP status (0: no answer), seconds, first key, count,
    error, monotonic send). Sets `reached` after `kill_at` calls."""
    rng = np.random.default_rng(SEED + 13)
    urls = cl.master_url.split(",")
    for i in range(n):
        if i == kill_at:
            reached.set()
        url = urls[i % len(urls)]
        count = int(rng.integers(1, 17))
        deadline = time.monotonic() + 10
        while True:
            m = next((m for m in cl.masters
                      if m is not None and m.url == url), None)
            role = ("down" if m is None else
                    "leader" if m.raft.is_leader else "follower")
            sent = time.monotonic()
            t0 = time.perf_counter()
            try:
                status, out = http.get_json(
                    f"http://{url}/dir/assign?count={count}", timeout=30)
            except (OSError, ValueError) as e:
                status, out = 0, {"error": type(e).__name__}
            key = FileId.parse(out["fid"]).key if status == 200 else None
            rows.append((time.monotonic(), role, status,
                         time.perf_counter() - t0, key, count,
                         out.get("error", ""), sent))
            if status in (0, 200) or time.monotonic() > deadline:
                break
            time.sleep(0.02)


def ha_record_assigns(master) -> list:
    """(index, entry term, count, first key) of every assign batch the
    master's raft applies from now on."""
    rec: list = []
    node, apply = master.raft, master.raft.apply_fn

    def recording(cmd: dict):
        out = apply(cmd)
        if "assign_batch" in cmd:
            rec.append((node.last_applied, node._term_at(node.last_applied),
                        max(1, int(cmd["assign_batch"]["count"])), out))
        return out

    node.apply_fn = recording
    return rec


def ha_overlaps(ranges: list) -> int:
    """Keys handed out twice among (first key, count) ranges."""
    dup, end = 0, 0
    for key, count in sorted(ranges):
        if key < end:
            dup += min(end, key + count) - key
        end = max(end, key + count)
    return dup


def ha_term(cl) -> int:
    """The highest raft term among the running masters."""
    return max(m.raft.term for m in cl.masters if m is not None)


def ha_captures_equal(cl) -> bool:
    caps = [m.metalog.capture() for m in cl.masters]
    return all(c == caps[0] for c in caps)


def ha_shard_paths(cl, info: dict, vid: int) -> dict:
    """sid -> the shard file of its first holder."""
    return {int(sid): os.path.join(
        cl.nodes[cl.index_of(urls[0])][3],
        f"{HA_COLLECTION}_{vid}{geometry.to_ext(int(sid))}")
        for sid, urls in info["shards"].items()}


def run_ha(work: Path, seed: int = SEED + 13, coder_name: str = "auto",
           device=None, limit_mb: int = HA_LIMIT_MB,
           max_needle: int = HA_MAX_NEEDLE, assigns: int = HA_ASSIGNS,
           kill_at: int = HA_KILL_AT) -> dict:
    """Phase 13; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 13d's encode, degraded reads and
    rebuild only; no other kernel); ``coder_name="torch", device="cpu"``
    at a few MB runs it on a host without one (no launch is counted
    there)."""
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    terms = [0]
    limit = limit_mb * MIB
    # (13a) three masters, the reference's raft timings, elected on the
    # cluster's loop; then four volume servers on two racks
    t0 = time.monotonic()
    (cl, launches["ha.elect"]) = counted(lambda: LocalCluster(
        0, coder_name=coder_name, device=device,
        volume_size_limit_mb=limit_mb, pulse=HA_PULSE,
        directory=str(work), racks=2, n_masters=3))
    try:
        leader = cl.wait_for_leader()
        elect_s = leader.raft.leader_since - t0
        records = {m.url: ha_record_assigns(m) for m in cl.masters}
        for _ in range(4):
            cl.add_volume_server()
        cl.wait_for_nodes(4)
        bal_log("ha.elect", elect_s, launches["ha.elect"],
                masters=cl.master_url, leader=leader.url,
                term=leader.raft.term,
                election_timeout=list(leader.raft.election_timeout),
                heartbeat=leader.raft.heartbeat_interval)
        client = Client(cl.master_url)
        vid = client.grow(count=1, collection=HA_COLLECTION)[
            "volume_ids"][0]
        holder = client.lookup(vid)[0]
        vol = cl.store(cl.index_of(holder)).find_volume(vid)

        def fill_and_fail_over():
            ctx = mp.get_context("spawn")
            stop, out = ctx.Event(), ctx.Queue()
            procs = [ctx.Process(target=_ha_upload_proc, args=(
                cl.master_url, HA_COLLECTION, seed, 1 + i * 10 ** 8,
                HA_CLIENTS // HA_PROCS, max_needle, stop, out),
                daemon=True)
                for i in range(HA_PROCS)]
            rows: list = []
            reached = threading.Event()
            stream = threading.Thread(target=ha_assign_stream, args=(
                cl, assigns, kill_at, reached, rows), daemon=True)
            t_start = time.perf_counter()
            for p in procs:
                p.start()
            stream.start()
            deadline = time.monotonic() + 300
            while not reached.is_set() and \
                    vol.data_file_size() < limit // 2:
                if time.monotonic() > deadline:
                    raise AssertionError("13a did not reach its middle")
                time.sleep(0.02)
            # (13b) the leader stopped in the middle of the stream
            old = cl.leader()
            idx = cl.masters.index(old)
            old_term = old.raft.term
            t_kill = time.monotonic()
            cl.stop_master(idx)
            t_stopped = time.monotonic()
            new = cl.wait_for_leader(timeout=60, exclude=(old,))
            to_leader = new.raft.leader_since - t_kill
            results: list = []
            full_at = None
            try:
                while len(results) < HA_PROCS:
                    if full_at is None and vol.data_file_size() >= limit:
                        full_at = time.perf_counter() - t_start
                        stop.set()
                    try:
                        results.append(out.get(timeout=0.2))
                    except queue.Empty:
                        if not any(p.is_alive() for p in procs) \
                                and out.empty():
                            raise AssertionError("an uploader died")
                    if time.perf_counter() - t_start > 600:
                        raise AssertionError("the fill did not end")
            finally:
                stop.set()
                for p in procs:
                    p.join(30)
                    if p.is_alive():
                        p.kill()
            stream.join(120)
            return {"rows": rows, "results": results, "old": old,
                    "idx": idx, "old_term": old_term, "new": new,
                    "t_kill": t_kill, "t_stopped": t_stopped,
                    "to_leader": to_leader,
                    "full_at": full_at,
                    "wall": time.perf_counter() - t_start}

        fo, launches["ha.fill_failover"] = counted(fill_and_fail_over)
        old, new, rows = fo["old"], fo["new"], fo["rows"]
        acked, assigned, up_lat, stalls, errors = [], [], [], [], []
        for a, r, lt, stall, err in fo["results"]:
            acked += a
            assigned += r
            up_lat += lt
            stalls.append(stall)
            errors += err
        if errors:
            raise AssertionError(f"uploads failed: {errors[:3]}")
        before = [r for r in rows if r[0] < fo["t_kill"] and r[2] == 200]
        after = [r for r in rows if r[0] >= fo["t_kill"] and r[2] == 200]
        ranges = assigned + [(r[4], r[5]) for r in rows if r[2] == 200]
        dup = ha_overlaps(ranges)
        # exact replay: the first key of the new leader's term is the old
        # leader's applied counter plus the batches of its term that were
        # in flight at the stop and that the new leader's log kept
        old_next = old.metalog.next_key
        old_commit = old.raft.commit_index
        mine = records[new.url]
        kept = sum(c for i, t, c, _ in mine
                   if i > old_commit and t <= fo["old_term"])
        first_new = next((k for i, t, c, k in mine if t > fo["old_term"]),
                         None)
        exact = first_new == old_next + kept
        lead = [r[3] for r in before if r[1] == "leader"]
        foll = [r[3] for r in before if r[1] == "follower"]
        stream_wall = (rows[-1][0] - rows[0][0]) if rows else 0.0
        bal_log("ha.fill", fo["full_at"] or fo["wall"],
                launches["ha.fill_failover"],
                uploads=len(acked), bytes=sum(s for _, _, s in acked),
                uploads_per_s=len(acked) / fo["wall"],
                upload_assign_p50_ms=float(np.percentile(up_lat, 50)) * 1e3,
                upload_assign_p99_ms=float(np.percentile(up_lat, 99)) * 1e3,
                upload_longest_assign_wait_s=max(stalls),
                stream_calls=len(rows),
                stream_assigns_ok=len(before) + len(after),
                stream_assigns_per_s=(len(before) + len(after))
                / max(stream_wall, 1e-9),
                to_leader=latency_summary(lead),
                through_follower=latency_summary(foll),
                refused=dict(collections.Counter(
                    f"{r[2]} {r[6][:60]}" for r in rows if r[2] != 200)),
                log_snap_index=new.raft.snap_index)
        # the first assign sent once the old leader was down
        first_ok = min((r[0] for r in after if r[7] >= fo["t_stopped"]),
                       default=None)
        bal_log("ha.failover", fo["to_leader"], None,
                old_leader=old.url, new_leader=new.url,
                new_term=new.raft.term, seconds_to_new_leader=fo["to_leader"],
                seconds_to_first_assign=(first_ok - fo["t_kill"]
                                         if first_ok else None),
                committed_next_key=old_next, inflight_kept_keys=kept,
                first_key_new_term=first_new, replay_exact=exact,
                keys_handed_out=sum(c for _, c in ranges),
                keys_repeated=dup)
        if dup or not exact or not after or new.raft.snap_index <= 0:
            raise AssertionError(
                f"13b: {dup} keys repeated, replay exact {exact}, "
                f"{len(after)} assigns after the stop, snap_index "
                f"{new.raft.snap_index}")

        # every acknowledged upload reads back, from its holder's files
        def read_acked():
            by_vid: dict = {}
            for fid, nid, size in acked:
                f = FileId.parse(fid)
                by_vid.setdefault(f.volume_id, []).append(
                    (f.key, f.cookie, nid, size))
            out = {"reads": 0, "failed": collections.Counter()}
            for v, want in by_vid.items():
                for url in client.lookup(v):
                    part = _verify_files(os.path.join(
                        cl.nodes[cl.index_of(url)][3],
                        f"{HA_COLLECTION}_{v}"), want, seed)
                    out["reads"] += part["reads"]
                    out["failed"].update(part["failed"])
            return out

        t = time.perf_counter()
        got, launches["ha.read_acked"] = counted(read_acked)
        bal_log("ha.read_acked", time.perf_counter() - t,
                launches["ha.read_acked"],
                reads=got["reads"], failed=dict(got["failed"]))
        if got["failed"] or got["reads"] != len(acked):
            raise AssertionError(f"13b reads: {got}")

        # (13c) the old leader restarts on its state directory: a
        # follower, its metadata log equal to the others' within a few
        # heartbeats (F6: its snapshot is applied state, never replayed)
        def restart():
            t = time.perf_counter()
            back = cl.restart_master(fo["idx"])
            wait_until(lambda: ha_captures_equal(cl)
                       and back.raft.leader_id == cl.leader().url
                       and not back.raft.is_leader,
                       "the restarted master's catch-up", HA_CATCH_UP_S)
            return back, time.perf_counter() - t

        (back, catch_up), launches["ha.restart"] = counted(restart)
        bal_log("ha.restart", catch_up, launches["ha.restart"],
                master=back.url, term=ha_term(cl),
                snap_index=back.raft.snap_index,
                next_key=back.metalog.next_key,
                captures_equal=ha_captures_equal(cl))
        if back.raft.snap_index <= 0:
            raise AssertionError("13c: the restarted master loaded no "
                                 "snapshot")

        # (13d) EC through the new leader: shell ec.encode sent to a
        # follower's URL (proxied, under the admin lease)
        leader = cl.leader()
        follower = next(m for m in cl.masters if m is not leader)
        fclient = Client(follower.url)
        owners: list = []
        lease = leader.lease_admin_token

        def leased(name, owner, previous):
            owners.append(owner)
            return lease(name, owner, previous)

        leader.lease_admin_token = leased
        vol_bytes = vol.data_file_size()
        t = time.perf_counter()
        try:
            _, launches["ha.ec_encode"] = counted(lambda: EcCommands(
                fclient, geometry.DEFAULT).encode(vid, HA_COLLECTION))
        finally:
            leader.lease_admin_token = lease
        secs = time.perf_counter() - t
        bal_log("ha.ec_encode", secs, launches["ha.ec_encode"],
                through=follower.url, leader=leader.url, term=ha_term(cl),
                bytes=vol_bytes,
                gbps=vol_bytes / secs / 1e9)
        if fclient.admin_lock.owner not in owners:
            raise AssertionError("13d: the encode's lease missed the "
                                 "leader")
        info = fclient.ec_lookup(vid)
        if len(info["shards"]) != 14:
            raise AssertionError(f"13d: shards {info}")
        mine_items = [(f, n, s) for f, n, s in acked
                      if FileId.parse(f).volume_id == vid]
        # the repair daemon waits while the degraded reads run
        for m in cl.masters:
            m.repair_enabled = False
        paths = ha_shard_paths(cl, info, vid)
        dropped = {sid: sha256_file(paths[sid]) for sid in VICTIMS}

        def drop():
            by_url: dict = {}
            for sid in VICTIMS:
                by_url.setdefault(info["shards"][str(sid)][0], []).append(
                    sid)
            for url, sids in by_url.items():
                fclient.volume_admin(url, "ec/delete_shards", {
                    "volume_id": vid, "collection": HA_COLLECTION,
                    "shard_ids": sids})
            wait_until(lambda: len(fclient.ec_lookup(vid)["shards"]) == 10,
                       "the lookup drops the four shards")

        _, launches["ha.drop"] = counted(drop)

        def reads(step: str):
            t = time.perf_counter()
            got = bal_read(cl.master_url, mine_items, seed, {vid: ""},
                           threads=HA_READERS)
            secs = time.perf_counter() - t
            bal_log(step, secs, None, term=ha_term(cl),
                    needles=len(mine_items),
                    bytes=got["bytes"],
                    gbps=got["bytes"] / secs / 1e9,
                    failed=dict(got["failed"]),
                    **latency_summary(got["lat"]))
            if got["failed"] or len(got["lat"]) != len(mine_items):
                raise AssertionError(f"{step}: {dict(got['failed'])}")

        _, launches["ha.read_degraded"] = counted(
            lambda: reads("ha.read_degraded"))

        def rebuild():
            t = time.perf_counter()
            for m in cl.masters:
                m.repair_enabled = True
            wait_until(lambda: len(fclient.ec_lookup(vid)["shards"]) == 14
                       and not cl.leader()._repairs_inflight,
                       "the repair daemon's rebuild", 120)
            return time.perf_counter() - t

        secs, launches["ha.rebuild"] = counted(rebuild)
        info = fclient.ec_lookup(vid)
        paths = ha_shard_paths(cl, info, vid)
        rebuilt = {sid: sha256_file(paths[sid]) for sid in VICTIMS}
        bal_log("ha.rebuild", secs, launches["ha.rebuild"],
                term=ha_term(cl), rebuilder=sorted({info["shards"][str(s)][0]
                                  for s in VICTIMS}),
                sha256_equal=rebuilt == dropped,
                repairs=cl.leader().metrics.value(
                    "repairs_succeeded", {"kind": "ec"}))
        if rebuilt != dropped:
            raise AssertionError("13d: rebuilt shards differ")
        # the volume servers forget the shard locations they cached
        # while four were lost (they would re-poll after 11 s)
        for node in cl.nodes:
            node[0]._shard_loc_cache.clear()
        _, launches["ha.read_back"] = counted(lambda: reads("ha.read_back"))
        # 1 at the start, 2 after 13b's stop; any more were elections of
        # a loaded loop
        terms[0] = ha_term(cl)
    finally:
        cl.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            if others or (step in HA_CODER_STEPS) != (counts["gf_apply"]
                                                      > 0):
                raise AssertionError(f"{step}: launches {counts}")
    bal_log("ha.summary", time.perf_counter() - t_phase, launches,
            final_term=terms[0])
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 14: the filer and the S3 lifecycle -----------------------------

FS_BUCKET = "/buckets/b1"
FS_COLLECTION = "b1"
FS_LIMIT_MB = 64
FS_ARC_BYTES = 160 * MIB
FS_OLD_BYTES = 8 * MIB
FS_KEEP_BYTES = 32 * MIB
FS_MAX_FILE = 32 * MIB        # phase 3's generator: log-uniform 1 KiB ..
FS_CHUNK_A = 8 * MIB          # filer A's chunks, the CLI's default
FS_CHUNK_B = 64 * 1024        # filer B's chunks
FS_BIG_CHUNKS = 1280          # filer B's file: one manifest of 1000 + 280
FS_KEEP2_MAX = 2 * MIB        # the files written while the daemon works
FS_WRITERS = 8                # HTTP writer and reader threads
FS_CODER_STEPS = ("filer.rules", "filer.read_degraded")
FS_RULES = (b"<LifecycleConfiguration>"
            b"<Rule><ID>old</ID><Filter><Prefix>old/</Prefix></Filter>"
            b"<Status>Enabled</Status>"
            b"<Expiration><Days>1</Days></Expiration></Rule>"
            b"<Rule><ID>arc</ID><Filter><Prefix>arc/</Prefix></Filter>"
            b"<Status>Enabled</Status>"
            b"<Transition><Days>0</Days><StorageClass>WARM"
            b"</StorageClass></Transition></Rule>"
            b"</LifecycleConfiguration>")


def fs_sizes(rng, total: int, lo: int, hi: int) -> list:
    """Log-uniform sizes in [lo, hi] summing to `total`."""
    sizes = []
    while total > 0:
        size = min(total, int(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        sizes.append(size)
        total -= size
    return sizes


def fs_ranges(rng, size: int, chunk: int, n: int = 3) -> list:
    """n (start, end) byte ranges, each across a chunk boundary when the
    file has one."""
    bounds = list(range(chunk, size, chunk))
    out = []
    for _ in range(n):
        if bounds:
            b = bounds[int(rng.integers(len(bounds)))]
            start = b - int(rng.integers(1, min(chunk, b) + 1))
            end = b + int(rng.integers(0, min(chunk, size - b)))
        else:
            start = int(rng.integers(size))
            end = int(rng.integers(start, size))
        out.append((start, end))
    return out


class FsFiles:
    """The phase's files: path -> (nid, size), bytes from phase 3's
    generator."""

    def __init__(self, seed: int):
        self.seed = seed
        self.files: dict = {}
        self.next_nid = 1

    def add(self, path: str, size: int) -> bytes:
        self.files[path] = (self.next_nid, size)
        self.next_nid += 1
        return self.data(path)

    def data(self, path: str) -> bytes:
        nid, size = self.files[path]
        return payload(self.seed, nid, size)

    def under(self, prefix: str) -> list:
        return [p for p in self.files if p.startswith(prefix)]

    def nbytes(self, prefix: str) -> int:
        return sum(self.files[p][1] for p in self.under(prefix))


def fs_put(filer: str, path: str, data: bytes, query: str = "") -> tuple:
    t0 = time.perf_counter()
    r = http.request("PUT", f"http://{filer}{path}{query}", data,
                     {"Content-Type": "application/octet-stream"},
                     timeout=600)
    return r.status, time.perf_counter() - t0, r.data


def fs_get(filer: str, path: str, rng: tuple = None):
    headers = {"Range": f"bytes={rng[0]}-{rng[1]}"} if rng else {}
    t0 = time.perf_counter()
    r = http.request("GET", f"http://{filer}{path}", headers=headers,
                     timeout=600)
    return r, time.perf_counter() - t0


def fs_meta(filer: str, route: str, **params) -> dict:
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    status, body = http.get_json(f"http://{filer}/__meta__/{route}?{qs}")
    if status != 200:
        raise AssertionError(f"{route} {params}: {status} {body}")
    return body


def fs_walk(filer: str, root: str) -> dict:
    """path -> entry JSON of everything under `root`."""
    out = {}
    start = ""
    while True:
        entries = fs_meta(filer, "list", dir=root, start=start,
                          limit=1024)["entries"]
        for e in entries:
            out[e["path"]] = e
            if e["attr"]["mode"] & 0o40000:
                out.update(fs_walk(filer, e["path"]))
        if len(entries) < 1024:
            return out
        start = entries[-1]["path"].rsplit("/", 1)[-1]


def fs_check_reads(filer, files: FsFiles, paths: list, chunk: int,
                   seed: int, ranges: int = 3, per_chunk: bool = False,
                   threads: int = FS_WRITERS) -> dict:
    """Every path read whole and by `ranges` ranges across chunk
    boundaries (and, with per_chunk, each chunk on its own), equal by
    sha256, through `filer` (a host:port, or a path -> host:port dict);
    latencies per file and per chunk."""
    from concurrent.futures import ThreadPoolExecutor

    def one(path: str) -> tuple:
        target = filer[path] if isinstance(filer, dict) else filer
        want = files.data(path)
        r, secs = fs_get(target, path)
        if r.status != 200 or hashlib.sha256(r.data).digest() != \
                hashlib.sha256(want).digest():
            raise AssertionError(f"{target}{path}: {r.status}, "
                                 f"{len(r.data)} of {len(want)} bytes")
        rng = np.random.default_rng((seed, files.files[path][0]))
        views = fs_ranges(rng, len(want), chunk, ranges)
        if per_chunk and len(want) > chunk:
            views += [(s, min(s + chunk, len(want)) - 1)
                      for s in range(0, len(want), chunk)]
        chunk_lat = [secs] if len(want) <= chunk else []
        for i, (s, e) in enumerate(views):
            rr, rs = fs_get(target, path, (s, e))
            if rr.status != 206 or rr.data != want[s:e + 1]:
                raise AssertionError(f"{target}{path} [{s}, {e}]: "
                                     f"{rr.status}")
            if i >= ranges:
                chunk_lat.append(rs)
        return secs, len(want), chunk_lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        got = list(ex.map(one, paths))
    secs = time.perf_counter() - t0
    out = {"files": len(got), "bytes": sum(g[1] for g in got),
           "seconds": secs,
           "per_file": latency_summary([g[0] for g in got])}
    chunk_lat = [x for g in got for x in g[2]]
    if per_chunk and chunk_lat:
        out["per_chunk"] = latency_summary(chunk_lat)
    return out


def fs_fid_status(master: str, fid: str) -> int:
    """The fid's GET status on every holder the master lists: 404 when
    each answers 404 (a freed chunk), else the first other status."""
    status, body = http.get_json(f"http://{master}/dir/lookup?fileId={fid}")
    if status == 404:
        return 404
    for loc in body.get("locations", []):
        r = http.request("GET", f"http://{loc['url']}/{fid}", timeout=60)
        if r.status != 404:
            return r.status
    return 404


def fs_deleted(fs) -> float:
    """Chunks the filer's deletion worker is done with: freed, or given
    up on."""
    return fs.metrics.value("chunks_freed") + \
        fs.metrics.value("chunks_not_freed")


def fs_wait_freed(master: str, fids: list, what: str,
                  timeout: float = 120.0, done=None) -> float:
    """Seconds until every fid answers 404 on every holder. ``done``, a
    predicate on the filer's deletion counters, is waited on first:
    polling each fid's holders while the worker frees them loads the
    servers' one event loop and slows the worker down."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.monotonic()
    while done is not None and not done() and \
            time.monotonic() - t0 < timeout:
        time.sleep(0.25)
    left = list(fids)
    while left:
        with ThreadPoolExecutor(FS_WRITERS) as ex:
            status = list(ex.map(lambda f: fs_fid_status(master, f), left))
        left = [f for f, st in zip(left, status) if st != 404]
        if left and time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: {len(left)} of {len(fids)} "
                                 f"chunks not freed, e.g. {left[:3]}")
        if left:
            time.sleep(0.25)
    return time.monotonic() - t0


def run_filer(work: Path, seed: int = SEED + 14, coder_name: str = "auto",
              device=None, limit_mb: int = FS_LIMIT_MB,
              arc_bytes: int = FS_ARC_BYTES, old_bytes: int = FS_OLD_BYTES,
              keep_bytes: int = FS_KEEP_BYTES,
              max_file: int = FS_MAX_FILE, chunk_a: int = FS_CHUNK_A,
              chunk_b: int = FS_CHUNK_B, big_chunks: int = FS_BIG_CHUNKS,
              keep2_max: int = FS_KEEP2_MAX) -> dict:
    """Phase 14; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 14b's warm-downs and 14c's degraded
    reads only; no other kernel); ``coder_name="torch", device="cpu"`` at
    a few MB runs it on a host without one (no launch is counted
    there)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.lifecycle import s3_rules
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    port_a = free_port()
    # the daemon's knobs from the environment, as a deployment sets them
    with env_set(WEED_LIFECYCLE_FILER=f"127.0.0.1:{port_a}",
                 WEED_LIFECYCLE_INTERVAL="0.5",
                 WEED_LIFECYCLE_DAY_SECONDS="1",
                 WEED_LIFECYCLE_WARM_AFTER=None,
                 WEED_LIFECYCLE_HOT_READ_RATE=None,
                 WEED_LIFECYCLE_COLLECTION_TTL=None):
        lc_cfg = LifecycleConfig.from_env()
    cl = LocalCluster(4, coder_name=coder_name, device=device,
                      volume_size_limit_mb=limit_mb, pulse=0.5,
                      directory=str(work / "cluster"), racks=2,
                      master_kwargs={"repair_enabled": False,
                                     "lifecycle_config": lc_cfg})
    procs = []
    try:
        fs_a = cl.add_filer("sqlite", chunk_a,
                            {"path": str(work / "filer_a.db")}, port=port_a)
        fs_b = cl.add_filer("memory", chunk_b)
        wait_until(lambda: fs_a.watch_messages and fs_b.watch_messages,
                   "the filers' watch snapshots")
        master = cl.master_url
        daemon = cl.master.lifecycle

        # (14a) uploads through filer A, the super-chunked file through B
        items = []
        for sub, total in (("arc", arc_bytes), ("old", old_bytes),
                           ("keep", keep_bytes)):
            for i, size in enumerate(fs_sizes(rng, total, 1024, max_file)):
                items.append(f"{FS_BUCKET}/{sub}/f{i:04d}.bin")
                files.add(items[-1], size)
        big = "/big/blob.bin"
        files.add(big, big_chunks * chunk_b)

        def upload() -> dict:
            def put(path: str) -> float:
                status, secs, body = fs_put(fs_a.url, path, files.data(path),
                                            f"?collection={FS_COLLECTION}")
                if status != 201:
                    raise AssertionError(f"PUT {path}: {status} {body!r}")
                return secs

            t0 = time.perf_counter()
            with ThreadPoolExecutor(FS_WRITERS) as ex:
                lat = list(ex.map(put, items))
            wall = time.perf_counter() - t0
            status, big_s, body = fs_put(fs_b.url, big, files.data(big))
            if status != 201:
                raise AssertionError(f"PUT {big}: {status} {body!r}")
            return {"wall": wall, "lat": lat, "big_s": big_s}

        up, launches["filer.upload"] = counted(upload)
        entry = fs_meta(fs_b.url, "lookup", path=big)
        manifests = [c for c in entry["chunks"] if c.get("is_chunk_manifest")]
        big_data = fs_meta(fs_b.url, "resolve_chunks",
                           path=big)["chunks"]
        if len(big_data) != big_chunks or len(manifests) != \
                big_chunks // 1000:
            raise AssertionError(f"{big}: {len(big_data)} data chunks, "
                                 f"{len(manifests)} manifests")
        hits = fs_a.metrics.value("assign_lease_hit")
        misses = fs_a.metrics.value("assign_lease_miss")
        nbytes = sum(files.files[p][1] for p in items)
        bal_log("filer.upload", up["wall"], launches["filer.upload"],
               files=len(items), bytes=nbytes,
               gbps=nbytes / up["wall"] / 1e9,
               per_file=latency_summary(up["lat"]),
               lease_hits=hits, lease_misses=misses,
               lease_hit_rate=hits / max(hits + misses, 1),
               big_file={"bytes": files.files[big][1],
                         "seconds": up["big_s"],
                         "gbps": files.files[big][1] / up["big_s"] / 1e9,
                         "chunks": len(entry["chunks"]),
                         "data_chunks": len(big_data),
                         "manifests": len(manifests)})

        def read_back() -> dict:
            a = fs_check_reads(fs_a.url, files, items, chunk_a, seed)
            b = fs_check_reads(fs_b.url, files, [big], chunk_b, seed,
                               ranges=4)
            # and across the manifest's edge
            edge = 1000 * chunk_b
            r, _ = fs_get(fs_b.url, big, (edge - 100, edge + 100))
            if r.data != files.data(big)[edge - 100:edge + 101]:
                raise AssertionError("read across the manifest edge")
            return {"a": a, "b": b}

        got, launches["filer.read_back"] = counted(read_back)
        bal_log("filer.read_back", got["a"]["seconds"] + got["b"]["seconds"],
               launches["filer.read_back"], filer_a=got["a"],
               filer_b=got["b"])

        # (14b) the rules on the bucket; keep2/ written meanwhile
        arc_fids = {p: [c["fid"] for c in fs_meta(fs_a.url, "lookup",
                                                  path=p)["chunks"]]
                    for p in files.under(f"{FS_BUCKET}/arc/")}
        arc_vids = sorted({int(f.split(",")[0]) for fl in arc_fids.values()
                           for f in fl})
        old_paths = files.under(f"{FS_BUCKET}/old/")
        old_fids = [c["fid"] for p in old_paths
                    for c in fs_meta(fs_a.url, "lookup", path=p)["chunks"]]
        records: list = []
        real_record = daemon._record

        def record(kind, vid, outcome, **kw):
            records.append((time.monotonic(), kind, vid, outcome,
                            kw.get("error", "")))
            return real_record(kind, vid, outcome, **kw)

        def warm_ok() -> dict:
            return {r[2]: r[0] for r in list(records)
                    if r[1] == "warm" and r[3] == "ok"}

        keep2: list = []
        keep2_failed: list = []
        stop = threading.Event()
        # the writer parks between files while ``go`` is clear
        go, parked = threading.Event(), threading.Event()
        go.set()

        def writer() -> None:
            wrng = np.random.default_rng(seed + 1)
            i = 0
            while not stop.is_set():
                if not go.is_set():
                    parked.set()
                    go.wait()
                    parked.clear()
                    continue
                path = f"{FS_BUCKET}/keep2/f{i:05d}.bin"
                size = int(np.exp(wrng.uniform(np.log(1024),
                                               np.log(keep2_max))))
                data = files.add(path, size)
                status, _, body = fs_put(fs_a.url, path, data,
                                         f"?collection={FS_COLLECTION}")
                if status == 201:
                    keep2.append(path)
                else:
                    keep2_failed.append((path, status, body[:200]))
                    files.files.pop(path)
                i += 1

        def rules() -> dict:
            bucket = fs_meta(fs_a.url, "lookup", path=FS_BUCKET)
            bucket["extended"] = {s3_rules.BUCKET_ATTR: s3_rules.rules_to_json(
                s3_rules.parse_lifecycle_xml(FS_RULES))}
            daemon._record = record
            t0 = time.monotonic()
            status, out = http.post_json(
                f"http://{fs_a.url}/__meta__/update_entry",
                {"entry": bucket})
            if status != 200:
                raise AssertionError(f"rules: {out}")
            w = threading.Thread(target=writer, name="keep2-writer")
            w.start()
            try:
                wait_until(lambda: set(arc_vids) <= set(warm_ok()),
                           "the daemon's warm-downs of the arc/ volumes",
                           timeout=600)
                late = late_arc()
                # every old/ object gone, and its chunks freed
                wait_until(lambda: all(
                    fs_get(fs_a.url, p)[0].status == 404
                    for p in old_paths), "old/ expired", timeout=120)
                freed_s = fs_wait_freed(master, old_fids, "old/ chunks")
            finally:
                stop.set()
                go.set()
                w.join()
                daemon._record = real_record
            return {"t0": t0, "freed_s": freed_s,
                    "secs": time.monotonic() - t0, **late}

        def late_arc() -> dict:
            """A warm-down under a live lease: with the writer parked, a
            late arc/ file takes its fid from the lease the writer draws
            on, so the daemon seals that leased volume (the file is due
            at once). The writer's next chunk POST meets the sealed
            volume, must bounce and land on a fresh fid."""
            pool = fs_a._assign_pool
            go.clear()
            if not parked.wait(120):
                raise AssertionError("the keep2/ writer did not park")
            stale0 = fs_a.metrics.value("upload_stale_assignment")
            for k in range(4):
                path = f"{FS_BUCKET}/arc/late{k}.bin"
                status, _, body = fs_put(fs_a.url, path,
                                         files.add(path, 4096),
                                         f"?collection={FS_COLLECTION}")
                if status != 201:
                    raise AssertionError(f"PUT {path}: {status} {body!r}")
                fid = fs_meta(fs_a.url, "lookup", path=path)["chunks"][0][
                    "fid"]
                vid = int(fid.split(",")[0])
                arc_fids[path] = [fid]
                lease = pool.core._leases.get((FS_COLLECTION, "", ""))
                if lease is not None and lease.vid == vid and \
                        lease.next_i < lease.count:
                    break
            else:
                raise AssertionError("no live lease holds a late arc/ fid")
            t_late = time.monotonic()

            def sealed() -> bool:
                return all(v is None or v.read_only
                           for v in (cl.store(i).find_volume(vid)
                                     for i in range(len(cl.nodes))))

            wait_until(sealed, f"the warm-down's seal of volume {vid}",
                       timeout=60)
            seal_s = time.monotonic() - t_late
            lease_age = time.monotonic() - lease.born
            go.set()
            if lease_age >= pool.core.ttl:
                raise AssertionError(
                    f"volume {vid} sealed {lease_age:.2f} s after its lease "
                    f"was filled, past the lease's {pool.core.ttl} s")
            wait_until(lambda: fs_a.metrics.value(
                "upload_stale_assignment") > stale0,
                f"a keep2/ chunk POST into sealed volume {vid}", timeout=60)
            wait_until(lambda: vid in warm_ok(),
                       f"the warm-down of volume {vid}", timeout=120)
            return {"late_vid": vid, "late_files": k + 1,
                    "late_seal_s": seal_s, "late_lease_age_s": lease_age}

        rs, launches["filer.rules"] = counted(rules)
        oks = warm_ok()
        first_warm_s = min(oks[v] for v in arc_vids) - rs["t0"]
        last_warm_s = max(oks[v] for v in arc_vids) - rs["t0"]
        if rs["late_vid"] not in arc_vids:
            arc_vids.append(rs["late_vid"])
        failed = [r for r in records if r[3] != "ok"]
        for p in arc_fids:
            ext = fs_meta(fs_a.url, "lookup", path=p).get("extended") or {}
            if ext.get(s3_rules.STORAGE_CLASS_ATTR) != s3_rules.WARM_CLASS:
                raise AssertionError(f"{p} not WARM: {ext}")
        for vid in arc_vids:
            shards = http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
            holders = [i for i in range(len(cl.nodes))
                       if cl.store(i).find_volume(vid) is not None]
            if len(shards.get("shards", {})) != 14 or holders:
                raise AssertionError(f"volume {vid}: shards {shards}, "
                                     f"normal copies on {holders}")
        keep2_read = fs_check_reads(fs_a.url, files, keep2, chunk_a, seed,
                                    ranges=1)
        stale = fs_a.metrics.value("upload_stale_assignment")
        bal_log("filer.rules", rs["secs"], launches["filer.rules"],
               warm_volumes=len(arc_vids),
               first_warm_s=first_warm_s, last_warm_s=last_warm_s,
               late_vid=rs["late_vid"], late_files=rs["late_files"],
               late_seal_s=rs["late_seal_s"],
               late_lease_age_s=rs["late_lease_age_s"],
               failed_records=[r[1:] for r in failed][:5],
               expired=len(old_paths), old_chunks_freed=len(old_fids),
               old_freed_s=rs["freed_s"],
               s3_records=sum(r[1].startswith("s3_") for r in records),
               keep2_acknowledged=len(keep2),
               keep2_refused=keep2_failed[:3],
               keep2_bytes=files.nbytes(f"{FS_BUCKET}/keep2/"),
               keep2_read=keep2_read, stale_assignments=stale,
               lease_invalidations=fs_a.metrics.value(
                   "assign_lease_invalidate"))
        if keep2_failed:
            raise AssertionError(f"keep2/ PUTs refused: {keep2_failed[:3]}")

        # (14c) shards {0, 3, 7, 12} of every warm volume dropped (kept
        # aside), every file read through filer A, the shards restored
        aside = work / "aside"
        aside.mkdir()
        dropped: list = []

        def drop() -> None:
            for vid in arc_vids:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    name = f"{FS_COLLECTION}_{vid}{geometry.to_ext(sid)}"
                    src = os.path.join(cl.nodes[cl.index_of(url)][3], name)
                    shutil.copy2(src, aside / name)
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": FS_COLLECTION,
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
                    dropped.append((vid, sid, url, src, name))
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v in arc_vids),
                "the lookup drops the four shards")

        _, launches["filer.drop_shards"] = counted(drop)
        readable = (files.under(f"{FS_BUCKET}/arc/")
                    + files.under(f"{FS_BUCKET}/keep/") + keep2)
        got, launches["filer.read_degraded"] = counted(
            lambda: fs_check_reads(fs_a.url, files, readable, chunk_a, seed,
                                   ranges=1, per_chunk=True))
        bal_log("filer.read_degraded", got["seconds"],
               launches["filer.read_degraded"], lost_shards=list(VICTIMS),
               volumes=len(arc_vids), **got,
               gbps=got["bytes"] / got["seconds"] / 1e9)

        def restore() -> None:
            for vid, sid, url, src, name in dropped:
                shutil.copy2(aside / name, src)
                status, out = http.post_json(
                    f"http://{url}/admin/ec/mount",
                    {"volume_id": vid, "collection": FS_COLLECTION,
                     "shard_ids": [sid]})
                if status != 200:
                    raise AssertionError(f"restore {vid}.{sid}: {out}")
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 for v in arc_vids),
                "the lookup lists the restored shards")

        _, launches["filer.restore_shards"] = counted(restore)
        shutil.rmtree(aside, ignore_errors=True)

        # (14d) the shell's fs.* commands against filer A, then B
        shell_commands._register_all()
        env = shell_commands.CommandEnv(Client(master), filer=fs_a.url)
        env_b = shell_commands.CommandEnv(Client(master), filer=fs_b.url)

        def run(e, *argv):
            return shell_commands.run_command(e, list(argv))

        def shell() -> dict:
            t0 = time.perf_counter()
            ls = run(env, "fs.ls", "-l", FS_BUCKET)
            du = run(env, "fs.du", FS_BUCKET)
            want = sum(files.nbytes(f"{FS_BUCKET}/{s}/")
                       for s in ("arc", "keep", "keep2"))
            if du["bytes"] != want:
                raise AssertionError(f"fs.du {du} != {want} bytes")
            one = files.under(f"{FS_BUCKET}/arc/")[0]
            if run(env, "fs.cat", one) != files.data(one):
                raise AssertionError(f"fs.cat {one}")
            run(env, "fs.mv", f"{FS_BUCKET}/keep", f"{FS_BUCKET}/kept")
            for p in files.under(f"{FS_BUCKET}/keep/"):
                files.files[p.replace("/keep/", "/kept/")] = \
                    files.files.pop(p)
            moved = fs_check_reads(fs_a.url, files,
                                   files.under(f"{FS_BUCKET}/kept/"),
                                   chunk_a, seed, ranges=0)
            keep2_fids = [c["fid"] for p in keep2
                          for c in fs_meta(fs_a.url, "lookup",
                                           path=p)["chunks"]]
            base = fs_deleted(fs_a)
            run(env, "fs.rm", "-r", f"{FS_BUCKET}/keep2")
            freed_s = fs_wait_freed(
                master, keep2_fids, "keep2/ chunks",
                done=lambda: fs_deleted(fs_a) - base >= len(keep2_fids))
            for p in keep2:
                files.files.pop(p)
            saved = run(env, "fs.meta.save", "-o",
                        str(work / "meta.jsonl"), "/buckets")
            loaded = run(env_b, "fs.meta.load", str(work / "meta.jsonl"))
            if fs_walk(fs_a.url, "/buckets") != fs_walk(fs_b.url,
                                                         "/buckets"):
                raise AssertionError("fs.meta.load: listings differ")
            return {"secs": time.perf_counter() - t0,
                    "ls": len(ls["entries"]), "du": du, "moved": moved,
                    "keep2_chunks_freed": len(keep2_fids),
                    "freed_s": freed_s, "saved": saved["entries"],
                    "loaded": loaded["entries"]}

        sh, launches["filer.shell"] = counted(shell)
        bal_log("filer.shell", sh.pop("secs"), launches["filer.shell"], **sh)

        # (14e) filer A restarted on its sqlite file; the CLI filer on
        # leveldb2; filer B's super-chunked file deleted
        def restart() -> dict:
            nonlocal fs_a
            t0 = time.perf_counter()
            before = fs_walk(fs_a.url, "/buckets")
            fs_a = cl.restart_filer(fs_a)
            wait_until(lambda: fs_a.watch_messages, "filer A's snapshot")
            restart_s = time.perf_counter() - t0
            if fs_walk(fs_a.url, "/buckets") != before:
                raise AssertionError("the restarted filer lists otherwise")
            one = files.under(f"{FS_BUCKET}/kept/")[0]
            if fs_get(fs_a.url, one)[0].data != files.data(one):
                raise AssertionError(f"after the restart: {one}")
            port_c = free_port()
            cli = [sys.executable, "-m", "seaweedfs_torch.cli"]
            procs.append(subprocess.Popen(
                cli + ["filer", "-port", str(port_c), "-mserver", master,
                       "-store", "leveldb2", "-store_path",
                       str(work / "filer_c")],
                cwd=str(REPO), stdout=subprocess.DEVNULL,
                stderr=open(work / "filer_c.log", "wb")))
            url_c = f"127.0.0.1:{port_c}"

            def up() -> bool:
                if procs[-1].poll() is not None:
                    raise AssertionError("the CLI filer exited")
                try:
                    return http.get_json(f"http://{url_c}/healthz")[0] == 200
                except OSError:
                    return False

            wait_until(up, "the CLI filer", timeout=120)
            cli_file = "/cli/one.bin"
            data = files.add(cli_file, chunk_a + 12345)
            status, _, body = fs_put(url_c, cli_file, data)
            if status != 201 or fs_get(url_c, cli_file)[0].data != data:
                raise AssertionError(f"CLI filer: {status} {body!r}")
            out = subprocess.run(
                cli + ["shell", "-master", master, "-filer", url_c,
                       "fs.ls", "/cli"],
                cwd=str(REPO), capture_output=True, text=True, timeout=120)
            listed = json.loads(out.stdout.strip().splitlines()[-1])
            if out.returncode != 0 or listed["entries"] != ["one.bin"]:
                raise AssertionError(f"shell -filer fs.ls: {out.stderr}")
            big_fids = [c["fid"] for c in big_data] + \
                [c["fid"] for c in manifests]
            base = fs_deleted(fs_b)
            r = http.request("DELETE", f"http://{fs_b.url}{big}")
            if r.status != 202:
                raise AssertionError(f"DELETE {big}: {r.status}")
            freed_s = fs_wait_freed(
                master, big_fids, "the big file's chunks",
                done=lambda: fs_deleted(fs_b) - base >= len(big_fids))
            return {"restart_s": restart_s, "listed": len(before),
                    "cli_filer": url_c, "big_chunks_freed": len(big_fids),
                    "freed_s": freed_s,
                    "secs": time.perf_counter() - t0}

        re_, launches["filer.restart"] = counted(restart)
        bal_log("filer.restart", re_.pop("secs"), launches["filer.restart"],
               **re_)
    finally:
        for p in procs:
            p.terminate()
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        cl.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            if others or (step in FS_CODER_STEPS) != (counts["gf_apply"]
                                                      > 0):
                raise AssertionError(f"{step}: launches {counts}")
    bal_log("filer.summary", time.perf_counter() - t_phase, launches)
    shutil.rmtree(work, ignore_errors=True)
    return launches


RING_BUCKET = "/buckets/ring"
RING_COLLECTION = "ring"          # the arc/ uploads
RING_OPS_COLLECTION = "ringops"   # 15d's files, on volumes never warmed
RING_META = "/ringmeta"           # the metadata-only creates
RING_LIMIT_MB = 64
# 20000 entries in 1000 directories took 184.0-244.5 s of phase on an
# H100 host (the creates alone 57.4-85.3 s), past the smoke's room: cut
# to 8000 in 400 (20 a directory, as there), then to 5000 in 250 to make
# room for phase 17 (42.7 s alone on an H100 host), then to 3000 in 150
# (the whole smoke took 1126 s of its 1200 on a slow H100 host), then to
# 2000 in 100 to make room for phase 18, then to 1500 in 75 for phase 20
# (the whole smoke took 1133.8 s on an H100 host whose phase 15 ran
# three times its usual time)
RING_ENTRIES = 1500
RING_DIRS = 75
RING_CLIENTS = 16                 # create clients, in RING_PROCS processes
RING_PROCS = 4
RING_UPLOAD_BYTES = 96 * MIB
RING_MAX_FILE = 8 * MIB           # phase 3's generator: log-uniform 1 KiB ..
RING_CHUNK = 8 * MIB              # the CLI filer's chunks
RING_UPLOADERS = 4                # upload threads, in their own process
RING_STOP_AT = 0.4                # acknowledged share when a filer dies
RING_OP_FILES = 48                # 15d's files, 4-64 KiB
RING_INVALIDATIONS = 20           # 15d's cached entries mutated
RING_ENTRY_TTL = 5.0              # the filers' entry-cache TTL (default)
RING_SWEEP_BOUND = 1.0            # a swept entry is seen within this
RING_CODER_STEPS = ("ring.warm_down", "ring.read_degraded")
RING_HOP = {"X-Seaweed-Ring-Hop": "1"}   # a request answered locally
RING_RULES = (b"<LifecycleConfiguration>"
              b"<Rule><ID>arc</ID><Filter><Prefix>arc/</Prefix></Filter>"
              b"<Status>Enabled</Status>"
              b"<Transition><Days>0</Days><StorageClass>WARM"
              b"</StorageClass></Transition></Rule>"
              b"</LifecycleConfiguration>")


def ring_entry_path(i: int, dirs: int) -> str:
    return f"{RING_META}/d{i % dirs:04d}/f{i:05d}.txt"


class RingOp:
    """One op of a ring client, sent to a random live peer until one
    acknowledges it (at most 120 s): a peer that refuses the connection
    is dropped from this client's choices (it died), a live peer's
    refusal (its ring has not dropped the dead owner yet) is tried again
    0.05 s later."""

    def __init__(self, peers: list, rng):
        self.peers = list(peers)
        self.rng = rng

    def run(self, send) -> tuple:
        """send(peer) -> acknowledged; returns (acknowledged, tries, wall
        time of a live peer's first refusal or None, the acknowledging
        peer)."""
        tries, refused, deadline = 0, None, time.time() + 120
        while time.time() < deadline:
            tries += 1
            peer = self.peers[int(self.rng.integers(len(self.peers)))]
            try:
                if send(peer):
                    return True, tries, refused, peer
                if refused is None:
                    refused = time.time()
            except ConnectionRefusedError:
                if len(self.peers) > 1:
                    self.peers.remove(peer)
                continue
            except Exception:
                # a peer that died mid-request
                pass
            time.sleep(0.05)
        return False, tries, refused, ""


def _ring_create_proc(peers: list, todo: list, dirs: int, seed: int,
                      threads: int, progress, out) -> None:
    """One create process: `threads` clients POST /__meta__/create_entry
    for their share of `todo` (entry numbers) through ``RingOp``. Puts
    (acks [(i, ack wall time, latency s, edge, tries, first refusal)],
    entries never acknowledged) on `out`."""
    from seaweedfs_torch.filer.entry import new_file
    lock = threading.Lock()
    acks, lost = [], []

    def loop(k: int) -> None:
        op = RingOp(peers, np.random.default_rng((seed, k, len(todo))))
        for i in todo[k::threads]:
            body = json.dumps({"entry": json.loads(new_file(
                ring_entry_path(i, dirs)).to_json())}).encode()
            t0 = time.perf_counter()
            ok, tries, refused, edge = op.run(lambda peer: http.request(
                "POST", f"http://{peer}/__meta__/create_entry", body,
                {"Content-Type": "application/json"},
                timeout=30).status == 200)
            with lock:
                if ok:
                    acks.append((i, time.time(), time.perf_counter() - t0,
                                 edge, tries, refused))
                else:
                    lost.append(i)
            if ok:
                with progress.get_lock():
                    progress.value += 1

    workers = [threading.Thread(target=loop, args=(k,), daemon=True)
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out.put(("create", acks, lost))


def _ring_upload_proc(peers: list, files: list, seed: int, threads: int,
                      out) -> None:
    """The upload process: `threads` writers PUT `files` [(path, nid,
    size)] of phase 3's generator through ``RingOp``
    (``?collection=ring``). Puts (acks [(path, ack wall time, latency s,
    tries, first refusal)], files never acknowledged, the writers'
    seconds) on `out`."""
    lock = threading.Lock()
    acks, lost = [], []

    def loop(k: int) -> None:
        op = RingOp(peers, np.random.default_rng((seed, k)))
        for path, nid, size in files[k::threads]:
            data = payload(seed, nid, size)
            t0 = time.perf_counter()
            ok, tries, refused, _ = op.run(lambda peer: http.request(
                "PUT", f"http://{peer}{path}?collection={RING_COLLECTION}",
                data, {"Content-Type": "application/octet-stream"},
                timeout=300).status == 201)
            with lock:
                if ok:
                    acks.append((path, time.time(),
                                 time.perf_counter() - t0, tries, refused))
                else:
                    lost.append(path)

    t0 = time.perf_counter()
    workers = [threading.Thread(target=loop, args=(k,), daemon=True)
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out.put(("upload", acks, lost, time.perf_counter() - t0))


def _ring_lookup_proc(peers: list, paths: list, threads: int, out) -> None:
    """Each path looked up through every peer of `peers`; puts the
    (peer, path, status) of each lookup that did not answer the path."""
    import urllib.parse
    lock = threading.Lock()
    missing = []

    def loop(k: int) -> None:
        for path in paths[k::threads]:
            q = urllib.parse.quote(path)
            for peer in peers:
                try:
                    status, body = http.get_json(
                        f"http://{peer}/__meta__/lookup?path={q}")
                except OSError as e:
                    status, body = repr(e), {}
                if status != 200 or body.get("path") != path:
                    with lock:
                        missing.append((peer, path, status))

    workers = [threading.Thread(target=loop, args=(k,), daemon=True)
               for k in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out.put(("lookup", missing))


def ring_procs(jobs: list, timeout: float = 600.0) -> list:
    """Run (target, args) jobs in spawned processes, each given a result
    queue as its last argument; returns their results in the order they
    come."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=t, args=(*a, out), daemon=True)
             for t, a in jobs]
    for p in procs:
        p.start()
    results = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < len(procs):
            try:
                results.append(out.get(timeout=0.2))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise AssertionError("a ring client process timed out")
                if not any(p.is_alive() for p in procs) and out.empty():
                    raise AssertionError("a ring client process died")
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
    return results


def cli_chunk_mb(chunk: int) -> str:
    """`chunk` as the CLI filer's ``-chunk_size_mb``, which takes whole
    MiB."""
    if chunk % MIB:
        raise ValueError(f"the CLI filer takes whole MiB chunks, not "
                         f"{chunk} bytes")
    return str(chunk // MIB)


def cli_env(extra: dict = None) -> dict:
    """This process's environment with the repo on PYTHONPATH (for a CLI
    process whose working directory is elsewhere) and `extra` added."""
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    return {**os.environ, "PYTHONPATH": os.pathsep.join(path),
            **(extra or {})}


class CliFiler:
    """A server of the port as its own process: ``python3 -m
    seaweedfs_torch.cli <args> -port <port>`` (0: a free one), logging
    to ``<name>_<port>.log`` in its work directory; in `cwd` (where the
    CLI reads its ``*.toml``) and with `env` added, when given."""

    def __init__(self, work: Path, args: list, name: str = "filer",
                 port: int = 0, cwd: Path = None, env: dict = None):
        self.url = f"127.0.0.1:{port or free_port()}"
        self.work = work
        self.name = name
        self.args = [sys.executable, "-m", "seaweedfs_torch.cli", *args,
                     "-port", self.url.split(":")[1]]
        self.cwd = cwd or REPO
        self.env = cli_env(env) if cwd is not None or env else None
        self.proc = None

    def start(self) -> None:
        with open(self.work / f"{self.name}_{self.url.split(':')[1]}"
                  ".log", "ab") as err:
            self.proc = subprocess.Popen(self.args, cwd=str(self.cwd),
                                         env=self.env,
                                         stdout=subprocess.DEVNULL,
                                         stderr=err)

    def up(self) -> bool:
        if self.proc.poll() is not None:
            raise AssertionError(f"{self.name} {self.url} exited "
                                 f"{self.proc.returncode}")
        try:
            return http.get_json(f"http://{self.url}/healthz")[0] == 200
        except OSError:
            return False

    def kill(self) -> None:
        """A death: SIGKILL, nothing flushed or closed."""
        self.proc.kill()
        self.proc.wait()

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def ring_status(url: str) -> dict:
    status, body = http.get_json(f"http://{url}/__meta__/ring/status")
    if status != 200:
        raise AssertionError(f"{url} ring status: {status} {body}")
    return body


def ring_adopted(urls: list, version: int) -> bool:
    """Every filer follows ring `version` and its handoff pass is over
    (a filer marks its pass running before it shows the new ring)."""
    for url in urls:
        st = ring_status(url)
        if st["ring"]["version"] != version:
            return False
        if st["handoff"]["state"] not in ("done", "idle"):
            if st["handoff"]["state"] == "failed":
                raise AssertionError(f"{url}: handoff failed: "
                                     f"{st['handoff']}")
            return False
    return True


async def _state(runner) -> str:
    """A handoff runner's state, read on its loop."""
    return runner.state


def ring_moved(urls: list) -> int:
    return sum(ring_status(u)["handoff"]["moved_dirs"] for u in urls)


def ring_freed(urls: list) -> float:
    """Chunks the filers' deletion workers are done with (freed or given
    up on), from their /metrics."""
    total = 0.0
    for url in urls:
        text = http.request("GET", f"http://{url}/metrics").data.decode()
        for line in text.splitlines():
            name, _, value = line.partition(" ")
            if name in ("seaweedfs_tpu_filer_chunks_freed_total",
                        "seaweedfs_tpu_filer_chunks_not_freed_total"):
                total += float(value)
    return total


def ring_local(url: str, route: str, **params) -> tuple:
    """A hop-marked meta GET: the peer answers from its own store."""
    import urllib.parse
    r = http.request("GET", f"http://{url}/__meta__/{route}?"
                     + urllib.parse.urlencode(params), headers=RING_HOP)
    return r.status, r.json()


def fs_meta_status(filer: str, path: str) -> int:
    """The status of a lookup of `path` through `filer`."""
    import urllib.parse
    return http.get_json(f"http://{filer}/__meta__/lookup?path="
                         f"{urllib.parse.quote(path)}")[0]


def run_ring(work: Path, seed: int = SEED + 15, coder_name: str = "auto",
             device=None, limit_mb: int = RING_LIMIT_MB,
             entries: int = RING_ENTRIES, dirs: int = RING_DIRS,
             upload_bytes: int = RING_UPLOAD_BYTES,
             max_file: int = RING_MAX_FILE, chunk: int = RING_CHUNK,
             op_files: int = RING_OP_FILES) -> dict:
    """Phase 15; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 15e's warm-down and degraded reads
    only; no other kernel); ``coder_name="torch", device="cpu"`` at a few
    MB runs it on a host without one (no launch is counted there)."""
    from seaweedfs_torch.filer.entry import new_file
    from seaweedfs_torch.lifecycle import s3_rules
    from seaweedfs_torch.metaring import DirectoryRing
    from seaweedfs_torch.metaring import handoff as handoff_mod
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    socks = LocalCluster.ring_sockets(3)
    ports = [s.getsockname()[1] for s in socks]
    peers = [f"127.0.0.1:{p}" for p in ports]
    with env_set(WEED_LIFECYCLE_FILER=peers[0],
                 WEED_LIFECYCLE_INTERVAL="0.5",
                 WEED_LIFECYCLE_DAY_SECONDS="1",
                 WEED_LIFECYCLE_WARM_AFTER=None,
                 WEED_LIFECYCLE_HOT_READ_RATE=None,
                 WEED_LIFECYCLE_COLLECTION_TTL=None):
        lc_cfg = LifecycleConfig.from_env()
    cl = LocalCluster(4, coder_name=coder_name, device=device,
                      volume_size_limit_mb=limit_mb, pulse=0.5,
                      directory=str(work / "cluster"), racks=2,
                      master_kwargs={"repair_enabled": False,
                                     "lifecycle_config": lc_cfg})
    # A in the smoke's process (the lifecycle daemon's filer, and the
    # handoff drill's), B and C each a CLI process of their own
    b, c = (CliFiler(work, [
        "filer", "-mserver", cl.master_url, "-store", "sqlite",
        "-store_path", str(work / f"ring_{p}.db"),
        "-chunk_size_mb", cli_chunk_mb(RING_CHUNK),
        "-ring_peers", ",".join(peers)], port=p) for p in ports[1:])
    try:
        master = cl.master_url
        for s in socks[1:]:
            s.close()       # each CLI filer binds its own
        b.start()
        c.start()
        fs_a = cl.add_filer("sqlite", chunk,
                            {"path": str(work / f"ring_{ports[0]}.db")},
                            sock=socks[0], ring_peers=peers)
        wait_until(lambda: b.up() and c.up(), "the CLI filers", timeout=120)
        # the membership through the master, as an operator sets it
        for p in peers:
            status, out = http.post_json(f"http://{master}/dir/ring/join",
                                         {"peer": p})
            if status != 200:
                raise AssertionError(f"join {p}: {out}")
        ring3 = DirectoryRing.from_dict(out["ring"])
        wait_until(lambda: ring_adopted(peers, ring3.version),
                   "the filers adopt the joined ring")
        survivors = peers[:2]
        shell_commands._register_all()
        env = shell_commands.CommandEnv(Client(master))

        # (15a) metadata-only creates by 16 clients in 4 processes, and
        # phase 3's files through another, each op to a random peer;
        # (15b) filer C killed once 40% of the creates are acknowledged
        # and removed with filer.ring.leave
        for i, size in enumerate(fs_sizes(rng, upload_bytes, 1024,
                                          max_file)):
            files.add(f"{RING_BUCKET}/arc/p{i % 8}/f{i:04d}.bin", size)
        arc = sorted(files.files)
        order = [int(x) for x in rng.permutation(entries)]
        progress = mp.get_context("spawn").Value("i", 0)
        stopped: dict = {}

        def stopper() -> None:
            wait_until(lambda: progress.value >= RING_STOP_AT * entries,
                       f"{RING_STOP_AT:.0%} of the creates", timeout=600)
            c.kill()
            stopped["t"] = time.time()
            stopped["acked_at_stop"] = progress.value
            out = shell_commands.run_command(
                env, ["filer.ring.leave", "-peer", c.url])
            stopped["leave_s"] = time.time() - stopped["t"]
            stopped["ring"] = DirectoryRing.from_dict(out["ring"])

        def traffic() -> list:
            jobs = [(_ring_create_proc, (peers, order[k::RING_PROCS], dirs,
                                         seed, RING_CLIENTS // RING_PROCS,
                                         progress))
                    for k in range(RING_PROCS)]
            jobs.append((_ring_upload_proc, (
                peers, [(p, *files.files[p]) for p in arc], seed,
                RING_UPLOADERS)))
            s = threading.Thread(target=stopper, name="ring-stopper")
            s.start()
            try:
                return ring_procs(jobs)
            finally:
                s.join()

        t0 = time.time()
        results, launches["ring.traffic"] = counted(traffic)
        if "ring" not in stopped:
            raise AssertionError("filer C was never removed")
        t_stop = stopped["t"]
        acks = [a for r in results if r[0] == "create" for a in r[1]]
        lost_creates = [i for r in results if r[0] == "create"
                        for i in r[2]]
        up = next(r for r in results if r[0] == "upload")
        if lost_creates or up[2]:
            raise AssertionError(f"never acknowledged: {len(lost_creates)} "
                                 f"creates, {up[2][:3]} uploads")
        create_wall = max(a[1] for a in acks) - t0

        def first_try(owned: bool) -> list:
            """Latencies of the creates acknowledged at their first try
            before the death, sent to the directory's owner or not."""
            return [a[2] for a in acks if a[1] < t_stop and a[4] == 1
                    and (ring3.owner(ring_entry_path(a[0], dirs).rsplit(
                        "/", 1)[0]) == a[3]) == owned]

        owner_lat, proxied_lat = first_try(True), first_try(False)
        # the ops a live peer refused after the death (its ring still
        # routed to the dead owner), and when the last of them converged
        refused = [a[1] for a in acks if a[5] is not None] + \
            [a[1] for a in up[1] if a[4] is not None]
        converged_s = max(refused + [t_stop]) - t_stop
        up_bytes = sum(files.files[a[0]][1] for a in up[1])
        bal_log("ring.creates", create_wall, launches["ring.traffic"],
                entries=len(acks), dirs=dirs, clients=RING_CLIENTS,
                processes=RING_PROCS, creates_per_s=len(acks) / create_wall,
                all=latency_summary([a[2] for a in acks]),
                owner=latency_summary(owner_lat),
                proxied=latency_summary(proxied_lat),
                proxied_share=len(proxied_lat) / max(
                    len(owner_lat) + len(proxied_lat), 1),
                tried_again=sum(a[4] > 1 for a in acks))
        bal_log("ring.uploads", up[3], files=len(up[1]), bytes=up_bytes,
                gbps=up_bytes / up[3] / 1e9,
                per_file=latency_summary([a[2] for a in up[1]]),
                tried_again=sum(a[3] > 1 for a in up[1]))
        bal_log("ring.peer_death", converged_s, killed=c.url,
                acked_at_kill=stopped["acked_at_stop"],
                leave_s=stopped["leave_s"], ops_refused_after=len(refused),
                stop_to_last_converged_s=converged_s,
                traffic_wall_s=time.time() - t0)

        # (15b) every acknowledged entry through each survivor, every
        # acknowledged file by sha256, once the survivors' handoff is done
        def loss_check() -> dict:
            t1 = time.perf_counter()
            wait_until(lambda: ring_adopted(survivors,
                                            stopped["ring"].version),
                       "the survivors' handoff after the leave",
                       timeout=300)
            handoff_s = time.perf_counter() - t1
            paths = [ring_entry_path(a[0], dirs) for a in acks]
            missing = [m for r in ring_procs([
                (_ring_lookup_proc, (survivors, paths[k::RING_PROCS], 4))
                for k in range(RING_PROCS)]) for m in r[1]]
            reads = fs_check_reads({p: survivors[k % 2]
                                    for k, p in enumerate(arc)}, files,
                                   arc, chunk, seed, ranges=1)
            return {"handoff_s": handoff_s, "missing": missing,
                    "reads": reads, "lookups": len(paths) * len(survivors),
                    "secs": time.perf_counter() - t1}

        lc, launches["ring.loss_check"] = counted(loss_check)
        bal_log("ring.loss_check", lc["secs"], launches["ring.loss_check"],
                acknowledged_entries=len(acks), lookups=lc["lookups"],
                acknowledged_entries_lost=len(lc["missing"]),
                missing=lc["missing"][:5], acknowledged_files=len(up[1]),
                files_read=lc["reads"]["files"],
                read_per_file=lc["reads"]["per_file"],
                leave_handoff_s=lc["handoff_s"],
                leave_moved_dirs=ring_moved(survivors))
        if lc["missing"]:
            raise AssertionError(f"acknowledged entries lost: "
                                 f"{len(lc['missing'])}, e.g. "
                                 f"{lc['missing'][:3]}")

        # (15c) C restarted on its store and joined again once it answers:
        # the handoff moves its directories back. A's pass of the join
        # runs under the ring.handoff fault, armed once it has moved a
        # third of its directories; cleared, a rerun resumes after the
        # watermark
        def handoff() -> dict:
            t1 = time.perf_counter()
            leave = stopped["ring"]
            c.start()
            wait_until(c.up, "the restarted filer", timeout=120)
            restart_s = time.perf_counter() - t1
            ring5 = DirectoryRing(peers=leave.peers + [c.url],
                                  vnodes=leave.vnodes,
                                  replicas=leave.replicas,
                                  version=leave.version + 1)
            moving = [d for d in sorted(fs_a.filer.store.iter_directories())
                      if leave.owners(d) != ring5.owners(d)
                      or fs_a.url not in ring5.owners(d)]
            first = max(1, len(moving) // 3)
            runner = fs_a.ring_handoff
            moved_b = ring_status(b.url)["handoff"]["moved_dirs"]

            async def arm() -> int:
                base = runner.moved_dirs
                while fs_a.ring.version != ring5.version or \
                        runner.moved_dirs - base < first:
                    await asyncio.sleep(0.01)
                faults.set_fault("ring.handoff", "error", count=1)
                return base

            armed = asyncio.run_coroutine_threadsafe(arm(), cl.loop)
            t2 = time.perf_counter()
            try:
                out = shell_commands.run_command(
                    env, ["filer.ring.join", "-peer", c.url])
                if out["ring"] != ring5.to_dict():
                    raise AssertionError(f"join: {out}")
                base = armed.result(timeout=300)
                wait_until(lambda: cl.call(_state(runner)) == "failed",
                           "A's pass to fail at the armed fault",
                           timeout=300)
            finally:
                armed.cancel()
                faults.clear("ring.handoff")
            first_moved = runner.moved_dirs - base
            mark = handoff_mod.read_watermark(fs_a.filer.store,
                                              ring5.version)
            t3 = time.perf_counter()
            resumed = cl.call(runner.run_once(ring5, leave))
            resume_s = time.perf_counter() - t3
            wait_until(lambda: ring_adopted(peers, ring5.version),
                       "every filer's handoff after the join", timeout=300)
            join_s = time.perf_counter() - t2
            skipped = sum(d <= mark for d in moving)
            if resumed != sum(d > mark for d in moving) or \
                    skipped != first_moved or not 0 < skipped < len(moving):
                raise AssertionError(
                    f"the rerun after the fault: {resumed} moved, "
                    f"{skipped} skipped, {first_moved} before the fault, "
                    f"{len(moving)} to move")
            # C's own store holds every acknowledged entry of each
            # directory whose replica set it is in
            want: dict = {}
            for a in acks:
                path = ring_entry_path(a[0], dirs)
                want.setdefault(path.rsplit("/", 1)[0], set()).add(path)
            mine = [d for d in sorted(want) if c.url in ring5.owners(d)]
            short = [d for d in mine if {e["path"] for e in ring_local(
                c.url, "list", dir=d, limit=1 << 20)[1]["entries"]}
                != want[d]]
            if short:
                raise AssertionError(f"the join's handoff left "
                                     f"{len(short)} of C's {len(mine)} "
                                     f"directories short, e.g. {short[:3]}")
            # the shell's view agrees with the master's
            st = shell_commands.run_command(env, ["filer.ring.status"])
            if st["ring"] != http.get_json(f"http://{master}/dir/ring")[1] \
                    or sorted(st["peers"]) != sorted(peers) or any(
                        "error" in row for row in st["peers"].values()):
                raise AssertionError(f"filer.ring.status: {st}")
            return {"restart_s": restart_s, "join_handoff_s": join_s,
                    "join_moved_dirs": {
                        "a": first_moved + resumed,
                        "b": ring_status(b.url)["handoff"]["moved_dirs"]
                        - moved_b,
                        "c": ring_status(c.url)["handoff"]["moved_dirs"]},
                    "c_dirs": len(mine), "a_dirs_to_move": len(moving),
                    "a_moved_before_fault": first_moved,
                    "rerun_skipped_dirs": skipped,
                    "rerun_moved_dirs": resumed, "rerun_s": resume_s,
                    "shell_owned_dirs": {p: row["owned_dirs"] for p, row
                                         in st["peers"].items()},
                    "secs": time.perf_counter() - t1}

        ho, launches["ring.handoff"] = counted(handoff)
        bal_log("ring.handoff", ho.pop("secs"), launches["ring.handoff"],
                **ho)

        # (15d) a recursive delete and a rename across partitions, and
        # the cross-peer cache sweep
        def cross_partition() -> dict:
            t1 = time.perf_counter()
            ops = {}
            for i in range(op_files):
                size = int(np.exp(rng.uniform(np.log(4096),
                                              np.log(64 * 1024))))
                side = "rm" if i % 2 else "mv/src"
                path = f"/ringops/{side}/s{i % 3}/t{i % 5}/f{i:03d}.bin"
                ops[path] = files.add(path, size)
            for k, (path, data) in enumerate(sorted(ops.items())):
                status, _, body = fs_put(peers[k % 3], path, data,
                                         f"?collection={RING_OPS_COLLECTION}")
                if status != 201:
                    raise AssertionError(f"PUT {path}: {status} {body!r}")
            rm = [p for p in ops if p.startswith("/ringops/rm/")]
            fids = [ch["fid"] for p in rm
                    for ch in fs_meta(peers[0], "lookup", path=p)["chunks"]]
            freed0 = ring_freed(peers)
            r = http.request("DELETE", f"http://{peers[1]}/ringops/rm"
                             "?recursive=true")
            if r.status != 202:
                raise AssertionError(f"DELETE /ringops/rm: {r.status}")
            subdirs = sorted({p.rsplit("/", 1)[0] for p in rm} | {
                p.rsplit("/", 2)[0] for p in rm} | {"/ringops/rm"})
            # no member's own store keeps a child of the tree, or the
            # entry of one of its directories (hop-marked listings read
            # the store, not the entry cache)
            orphans = [(u, d) for u in peers for d in subdirs
                       if ring_local(u, "list", dir=d, limit=1)[1]["entries"]
                       or d in {e["path"] for e in ring_local(
                           u, "list", dir=d.rsplit("/", 1)[0],
                           limit=1 << 20)[1]["entries"]}]
            if orphans:
                raise AssertionError(f"the recursive delete left {orphans[:3]}")
            # and every member answers 404 for all of it once the other
            # members' cached answers are swept (within the cache's TTL)
            wait_until(lambda: all(fs_meta_status(u, p) == 404
                                   for p in rm + subdirs for u in peers),
                       "every member to answer 404 for the deleted tree",
                       timeout=RING_ENTRY_TTL)
            freed_s = fs_wait_freed(
                master, fids, "the recursive delete's chunks",
                done=lambda: ring_freed(peers) - freed0 >= len(fids))
            freed = ring_freed(peers) - freed0
            mv = [p for p in ops if p.startswith("/ringops/mv/src/")]
            r = http.request("POST", f"http://{peers[2]}/ringops/mv/src"
                             "?mv.to=/ringops/mv/dst")
            if r.status != 200:
                raise AssertionError(f"rename: {r.status} {r.data!r}")
            for p in mv:
                files.files[p.replace("/src/", "/dst/")] = files.files.pop(p)
            moved = fs_check_reads(peers[0], files,
                                   files.under("/ringops/mv/dst/"), chunk,
                                   seed, ranges=0)
            wait_until(lambda: all(fs_meta_status(u, p) == 404
                                   for p in mv for u in peers),
                       "every member to answer 404 for the renamed paths",
                       timeout=RING_ENTRY_TTL)
            return {"rm_files": len(rm), "rm_dirs": len(subdirs),
                    "rm_chunks": len(fids), "chunks_freed": freed,
                    "freed_s": freed_s, "mv_files": len(mv),
                    "mv_read": moved, "secs": time.perf_counter() - t1}

        xp, launches["ring.cross_partition"] = counted(cross_partition)
        bal_log("ring.cross_partition", xp.pop("secs"),
                launches["ring.cross_partition"], **xp)

        def invalidation() -> dict:
            """An entry cached by the peer outside its replica set, then
            changed through its owner: the peer serves the change within
            RING_SWEEP_BOUND s, long before its entry cache's TTL."""
            t1 = time.perf_counter()
            lat = []
            swept0 = sum(ring_status(u)["invalidation"]["swept"]
                         for u in peers)
            for k in range(RING_INVALIDATIONS):
                path = ring_entry_path(acks[k][0], dirs)
                owners = fs_a.ring.owners(path.rsplit("/", 1)[0])
                observer = next(u for u in peers if u not in owners)
                e = new_file(path)
                e.extended = {"v": f"old{k}"}
                status, out = http.post_json(
                    f"http://{owners[0]}/__meta__/update_entry",
                    {"entry": json.loads(e.to_json())})
                wait_until(lambda: fs_meta(observer, "lookup", path=path)
                           .get("extended", {}).get("v") == f"old{k}",
                           f"{observer} caches {path}",
                           timeout=RING_ENTRY_TTL + 5)
                e.extended = {"v": f"new{k}"}
                t2 = time.perf_counter()
                status, out = http.post_json(
                    f"http://{owners[0]}/__meta__/update_entry",
                    {"entry": json.loads(e.to_json())})
                if status != 200:
                    raise AssertionError(f"update {path}: {out}")
                wait_until(lambda: fs_meta(observer, "lookup", path=path)
                           .get("extended", {}).get("v") == f"new{k}",
                           f"{observer} sees the update of {path}",
                           timeout=RING_SWEEP_BOUND)
                lat.append(time.perf_counter() - t2)
            swept = sum(ring_status(u)["invalidation"]["swept"]
                        for u in peers) - swept0
            if not swept:
                raise AssertionError("no peer swept its cache")
            return {"entries": len(lat), "seen": latency_summary(lat),
                    "bound_s": RING_SWEEP_BOUND, "ttl_s": RING_ENTRY_TTL,
                    "swept": swept, "secs": time.perf_counter() - t1}

        iv, launches["ring.invalidation"] = counted(invalidation)
        bal_log("ring.invalidation", iv.pop("secs"),
                launches["ring.invalidation"], **iv)

        # (15e) the bucket's rule warms arc/ down to the EC tier on the
        # card; the files read through a non-owner with 4 shards lost
        daemon = cl.master.lifecycle
        arc_vids = sorted({int(ch["fid"].split(",")[0]) for p in arc
                           for ch in fs_meta(peers[0], "lookup",
                                             path=p)["chunks"]})
        records: list = []
        real_record = daemon._record

        def record(kind, vid, outcome, **kw):
            records.append((time.monotonic(), kind, vid, outcome))
            return real_record(kind, vid, outcome, **kw)

        def warm_ok() -> dict:
            return {r[2]: r[0] for r in list(records)
                    if r[1] == "warm" and r[3] == "ok"}

        def warm_down() -> dict:
            bucket = fs_meta(peers[1], "lookup", path=RING_BUCKET)
            bucket["extended"] = {s3_rules.BUCKET_ATTR: s3_rules.rules_to_json(
                s3_rules.parse_lifecycle_xml(RING_RULES))}
            daemon._record = record
            t1 = time.monotonic()
            try:
                status, out = http.post_json(
                    f"http://{peers[1]}/__meta__/update_entry",
                    {"entry": bucket})
                if status != 200:
                    raise AssertionError(f"rules: {out}")
                wait_until(lambda: set(arc_vids) <= set(warm_ok()),
                           "the warm-downs of the arc/ volumes", timeout=600)
            finally:
                daemon._record = real_record
            return {"first_s": min(warm_ok()[v] for v in arc_vids) - t1,
                    "last_s": max(warm_ok()[v] for v in arc_vids) - t1}

        wd, launches["ring.warm_down"] = counted(warm_down)
        for p in arc:
            ext = fs_meta(peers[2], "lookup", path=p).get("extended") or {}
            if ext.get(s3_rules.STORAGE_CLASS_ATTR) != s3_rules.WARM_CLASS:
                raise AssertionError(f"{p} not WARM: {ext}")
        for vid in arc_vids:
            shards = http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
            holders = [i for i in range(len(cl.nodes))
                       if cl.store(i).find_volume(vid) is not None]
            if len(shards.get("shards", {})) != 14 or holders:
                raise AssertionError(f"volume {vid}: shards {shards}, "
                                     f"normal copies on {holders}")
        bal_log("ring.warm_down", wd["last_s"], launches["ring.warm_down"],
                volumes=len(arc_vids), first_warm_s=wd["first_s"],
                last_warm_s=wd["last_s"])

        def drop() -> None:
            for vid in arc_vids:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": RING_COLLECTION,
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v in arc_vids),
                "the lookup drops the four shards")

        _, launches["ring.drop_shards"] = counted(drop)

        def read_degraded() -> dict:
            # each file through the one peer outside its directory's
            # replica set: the lookup is proxied, the chunks read degraded
            outside = {p: next(u for u in peers if u not in fs_a.ring.owners(
                p.rsplit("/", 1)[0])) for p in arc}
            got = fs_check_reads(outside, files, arc, chunk, seed, ranges=1)
            got["peers"] = sorted(set(outside.values()))
            return got

        rd, launches["ring.read_degraded"] = counted(read_degraded)
        bal_log("ring.read_degraded", rd["seconds"],
                launches["ring.read_degraded"], lost_shards=list(VICTIMS),
                volumes=len(arc_vids), **rd,
                gbps=rd["bytes"] / rd["seconds"] / 1e9)
    finally:
        faults.clear("ring.handoff")
        b.stop()
        c.stop()
        cl.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            if others or (step in RING_CODER_STEPS) != (counts["gf_apply"]
                                                        > 0):
                raise AssertionError(f"{step}: launches {counts}")
    bal_log("ring.summary", time.perf_counter() - t_phase, launches,
            gf_apply_per_step={k: v["gf_apply"] for k, v in launches.items()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


NETS_STORES = ("redis", "redis2", "etcd", "mongodb", "elastic", "cassandra")
NETS_CLI_STORE = "redis2"         # the CLI filer the shell reads back
NETS_LIMIT_MB = 64
NETS_ENTRIES = 1000               # metadata-only creates per store
NETS_DIRS = 50
NETS_CLIENTS = 8                  # create clients per store
NETS_PAGE = 100                   # the listing's page
NETS_STORE_BYTES = 16 * MIB       # files per store
NETS_MAX_FILE = 8 * MIB           # phase 3's generator: log-uniform 1 KiB ..
NETS_CHUNK = 8 * MIB              # the filers' chunks
NETS_COLLECTION = "nets"
NETS_META = "/nets-meta"
NETS_CODER_STEPS = ("nets.ec_encode", "nets.read_degraded")
# one fake server: its port on stdout, then serve until stdin closes
_FAKE_SERVER = """
import importlib, sys
sys.path.insert(0, sys.argv[1])
fake = getattr(importlib.import_module(
    "seaweedfs_torch.filer." + sys.argv[2]), sys.argv[3])()
print(fake.port, flush=True)
sys.stdin.read()
fake.close()
"""
# one store's create clients: POST /__meta__/create_entry once for each
# path, `threads` at once; the acknowledged (path, seconds), the failed
# (path, status or error) and the wall seconds as JSON on stdout
_NETS_CREATE = """
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
from seaweedfs_torch.filer.entry import new_file
from seaweedfs_torch.server import http
job = json.loads(sys.argv[2])
acks, failed, lock = [], [], threading.Lock()

def loop(k):
    for path in job["paths"][k::job["threads"]]:
        body = json.dumps({"entry": json.loads(new_file(path).to_json())})
        t0 = time.perf_counter()
        try:
            why = http.request(
                "POST", "http://%s/__meta__/create_entry" % job["filer"],
                body.encode(), {"Content-Type": "application/json"},
                timeout=60).status
        except OSError as e:
            why = repr(e)
        with lock:
            if why == 200:
                acks.append((path, time.perf_counter() - t0))
            else:
                failed.append((path, why))

t0 = time.perf_counter()
workers = [threading.Thread(target=loop, args=(k,))
           for k in range(job["threads"])]
for w in workers:
    w.start()
for w in workers:
    w.join()
print(json.dumps({"acks": acks, "failed": failed,
                  "seconds": time.perf_counter() - t0}))
"""


def nets_entry_path(i: int, dirs: int) -> str:
    return f"{NETS_META}/d{i % dirs:04d}/e{i:05d}"


class FakeServers:
    """Phase 16's fake servers, each a process of its own (in this one
    they would share its GIL with the filers); ``ports[name]``."""

    def __init__(self, fakes: dict):
        self.procs = {name: subprocess.Popen(
            [sys.executable, "-c", _FAKE_SERVER, str(REPO), module, cls],
            cwd=str(REPO), stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            for name, (module, cls) in fakes.items()}
        self.ports = {}
        for name, proc in self.procs.items():
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"fake {name} did not start")
            self.ports[name] = int(line)

    def stop(self) -> None:
        for proc in self.procs.values():
            proc.stdin.close()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def nets_list(filer: str, directory: str, page: int = NETS_PAGE) -> list:
    """A directory's names, listed `page` at a time."""
    names: list = []
    while True:
        got = [e["path"].rsplit("/", 1)[1] for e in fs_meta(
            filer, "list", dir=directory,
            start=names[-1] if names else "", limit=page)["entries"]]
        names += got
        if len(got) < page:
            return names


def run_nets(work: Path, seed: int = SEED + 16, coder_name: str = "auto",
             device=None, limit_mb: int = NETS_LIMIT_MB,
             entries: int = NETS_ENTRIES, dirs: int = NETS_DIRS,
             store_bytes: int = NETS_STORE_BYTES,
             max_file: int = NETS_MAX_FILE, chunk: int = NETS_CHUNK) -> dict:
    """Phase 16; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 16b's ec.encode and degraded reads
    only; no other kernel); ``coder_name="torch", device="cpu"`` at a few
    MB runs it on a host without one (no launch is counted there)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.balance import BalanceConfig
    from seaweedfs_torch.filer.redis_store import _RespClient
    from seaweedfs_torch.filer.stores import NETWORK_STORES
    from seaweedfs_torch.topology.sequence import KvSequencer
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    # (first key, count, which master's sequencer) of every batch minted
    minted: list = []
    made: list = []

    class RecordingKv(KvSequencer):
        def __init__(self, *args):
            super().__init__(*args)
            self.start = len(made)
            made.append(self)

        def next_file_id(self, count: int = 1) -> int:
            first = super().next_file_id(count)
            minted.append((first, count, self.start))
            return first

    fakes = FakeServers({name: NETWORK_STORES[kind][:2] for name, kind in (
        ("sequencer", "redis"), *((k, k) for k in NETS_STORES))})
    seq_port = fakes.ports["sequencer"]
    cl = None
    filers: dict = {}
    try:
        cl = LocalCluster(2, coder_name=coder_name, device=device,
                          volume_size_limit_mb=limit_mb, pulse=0.5,
                          directory=str(work / "cluster"), racks=2,
                          master_kwargs={
                              "repair_enabled": False,
                              "balance_config": BalanceConfig(
                                  force_enabled=False)},
                          sequencer=lambda: RecordingKv("127.0.0.1",
                                                        seq_port))
        master = cl.master_url
        for kind in NETS_STORES:
            filers[kind] = CliFiler(work, [
                "filer", "-mserver", master, "-store", kind,
                "-store_servers", f"127.0.0.1:{fakes.ports[kind]}",
                "-chunk_size_mb", cli_chunk_mb(chunk)])
            filers[kind].start()
        cli = filers[NETS_CLI_STORE]
        urls = {kind: fs.url for kind, fs in filers.items()}
        wait_until(lambda: all(fs.up() for fs in filers.values()),
                   "the filers", timeout=120)
        log({"phase": "nets.setup", "seconds": time.perf_counter() - t_phase,
             "filers": urls, "fakes": fakes.ports})

        # (16a) 8 clients a store create the metadata-only entries; every
        # directory listed back a page at a time; a rename across
        # directories and a recursive delete
        paths = [nets_entry_path(int(i), dirs)
                 for i in rng.permutation(entries)]

        def creates() -> dict:
            procs = {kind: subprocess.Popen(
                [sys.executable, "-c", _NETS_CREATE, str(REPO), json.dumps(
                    {"filer": urls[kind], "paths": paths,
                     "threads": NETS_CLIENTS})],
                cwd=str(REPO), stdout=subprocess.PIPE)
                for kind in NETS_STORES}
            out = {}
            for kind, proc in procs.items():
                stdout, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"{kind} create clients exited "
                                         f"{proc.returncode}")
                out[kind] = json.loads(stdout.splitlines()[-1])
            return out

        t0 = time.perf_counter()
        got, launches["nets.creates"] = counted(creates)
        create_s = time.perf_counter() - t0
        per_store = {}
        for kind, r in got.items():
            if r["failed"] or len(r["acks"]) != entries:
                raise AssertionError(f"{kind}: {len(r['failed'])} creates "
                                     f"failed, first {r['failed'][:3]}")
            per_store[kind] = {
                "creates_per_s": len(r["acks"]) / r["seconds"],
                **latency_summary([a[1] for a in r["acks"]])}
        bal_log("nets.creates", create_s, launches["nets.creates"],
                entries_per_store=entries, dirs=dirs,
                clients_per_store=NETS_CLIENTS, per_store=per_store,
                creates_per_s=len(NETS_STORES) * entries / create_s)
        want: dict = {}
        for p in paths:
            d, name = p.rsplit("/", 1)
            want.setdefault(d, set()).add(name)
        moved_from, deleted = nets_entry_path(1, dirs).rsplit("/", 1)[0], \
            nets_entry_path(2, dirs).rsplit("/", 1)[0]
        moved_to = f"{NETS_META}/moved/{moved_from.rsplit('/', 1)[1]}"

        def listing() -> dict:
            t1 = time.perf_counter()
            lost = [(kind, d) for kind in NETS_STORES for d in sorted(want)
                    if nets_list(urls[kind], d) != sorted(want[d])]
            list_s = time.perf_counter() - t1
            for kind, url in urls.items():
                r = http.request("POST", f"http://{url}{moved_from}"
                                 f"?mv.to={moved_to}")
                if r.status != 200:
                    raise AssertionError(f"{kind} rename: {r.status}")
                r = http.request("DELETE", f"http://{url}{deleted}"
                                 "?recursive=true")
                if r.status != 202:
                    raise AssertionError(f"{kind} delete: {r.status}")
                if nets_list(url, moved_to) != sorted(want[moved_from]) \
                        or nets_list(url, deleted) \
                        or fs_meta_status(url, moved_from) != 404 \
                        or fs_meta_status(url, deleted) != 404 \
                        or fs_meta_status(url, f"{deleted}/e00002") != 404:
                    raise AssertionError(f"{kind}: the rename or the "
                                         f"delete shows otherwise")
                top = set(want) - {moved_from, deleted}
                if nets_list(url, NETS_META) != sorted(
                        {d.rsplit("/", 1)[1] for d in top} | {"moved"}):
                    raise AssertionError(f"{kind}: {NETS_META} lists "
                                         f"otherwise")
            return {"lost": lost, "list_s": list_s,
                    "secs": time.perf_counter() - t1}

        ls, launches["nets.listing"] = counted(listing)
        bal_log("nets.listing", ls.pop("secs"), launches["nets.listing"],
                acknowledged_entries=len(NETS_STORES) * entries,
                listings=len(NETS_STORES) * len(want), page=NETS_PAGE,
                acknowledged_entries_lost=len(ls["lost"]),
                lost=ls["lost"][:5], list_s=ls["list_s"],
                renamed=moved_to, deleted=deleted)
        if ls["lost"]:
            raise AssertionError(f"directories list otherwise: "
                                 f"{ls['lost'][:3]}")

        # (16b) phase 3's files through each filer, the master restarted
        # halfway; the volumes EC-encoded through the shell; every file
        # read with 4 shards lost; the shards put back
        for kind in NETS_STORES:
            for i, size in enumerate(fs_sizes(rng, store_bytes, 1024,
                                              max_file)):
                files.add(f"/buckets/nets-{kind}/f{i:03d}.bin", size)
        by_store = {kind: files.under(f"/buckets/nets-{kind}/")
                    for kind in NETS_STORES}
        owner = {p: urls[kind] for kind, ps in by_store.items() for p in ps}

        def upload(paths_: list) -> list:
            def one(path: str) -> tuple:
                status, secs, body = fs_put(
                    owner[path], path, files.data(path),
                    f"?collection={NETS_COLLECTION}")
                if status != 201:
                    raise AssertionError(f"PUT {path}: {status} {body!r}")
                return secs

            with ThreadPoolExecutor(2 * len(NETS_STORES)) as ex:
                return list(ex.map(one, paths_))

        halves = [[p for ps in by_store.values() for p in ps[h::2]]
                  for h in (0, 1)]
        t0 = time.perf_counter()
        lat, launches["nets.uploads"] = counted(lambda: upload(halves[0]))

        def restart_master() -> float:
            t1 = time.perf_counter()
            cl.restart_master(0)
            cl.wait_for_nodes(2)
            wait_until(lambda: http.get_json(
                f"http://{master}/dir/assign?collection="
                f"{NETS_COLLECTION}")[0] == 200,
                "an assign through the restarted master")
            return time.perf_counter() - t1

        restart_s, launches["nets.master_restart"] = counted(restart_master)
        more, more_launches = counted(lambda: upload(halves[1]))
        up_s = time.perf_counter() - t0 - restart_s
        for k, n in more_launches.items():
            launches["nets.uploads"][k] += n
        lat += more
        nbytes = sum(files.files[p][1] for p in files.files)
        keys = [int(FileId.parse(ch["fid"]).key) for p in files.files
                for ch in fs_meta(owner[p], "lookup", path=p)["chunks"]]
        before = [(k, n) for k, n, m in minted if m == 0]
        after = [(k, n) for k, n, m in minted if m == 1]
        kv = _RespClient("127.0.0.1", seq_port)
        counter = int(kv.command("GET", "master/sequence"))
        kv.close()
        if len(set(keys)) != len(keys) or ha_overlaps(before + after) \
                or not before or not after or len(made) != 2 \
                or min(k for k, _ in after) <= max(k + n - 1
                                                   for k, n in before) \
                or counter < max(k + n - 1 for k, n in before + after):
            raise AssertionError(f"keys across the master's restart: "
                                 f"{len(keys)} chunks, {len(set(keys))} "
                                 f"keys, batches {before[-3:]} then "
                                 f"{after[:3]}, counter {counter}")
        bal_log("nets.uploads", up_s, launches["nets.uploads"],
                files=len(files.files), bytes=nbytes,
                gbps=nbytes / up_s / 1e9, per_file=latency_summary(lat))
        bal_log("nets.master_restart", restart_s,
                launches["nets.master_restart"], chunks=len(keys),
                batches_before=len(before), batches_after=len(after),
                last_key_before=max(k + n - 1 for k, n in before),
                first_key_after=min(k for k, _ in after),
                kv_counter=counter, keys_repeated=0)

        vids = sorted({int(FileId.parse(ch["fid"]).volume_id)
                       for p in files.files
                       for ch in fs_meta(owner[p], "lookup",
                                         path=p)["chunks"]})
        shell_commands._register_all()
        env = shell_commands.CommandEnv(Client(master))

        def ec_encode() -> None:
            for vid in vids:
                shell_commands.run_command(
                    env, ["ec.encode", "-volumeId", str(vid),
                          "-collection", NETS_COLLECTION])
            for vid in vids:
                shards = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                if len(shards.get("shards", {})) != 14 or any(
                        cl.store(i).find_volume(vid) is not None
                        for i in range(len(cl.nodes))):
                    raise AssertionError(f"ec.encode {vid}: {shards}")

        t0 = time.perf_counter()
        _, launches["nets.ec_encode"] = counted(ec_encode)
        bal_log("nets.ec_encode", time.perf_counter() - t0,
                launches["nets.ec_encode"], volumes=vids)
        aside = work / "aside"
        aside.mkdir()
        dropped: list = []

        def drop() -> None:
            for vid in vids:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    name = f"{NETS_COLLECTION}_{vid}{geometry.to_ext(sid)}"
                    src = os.path.join(cl.nodes[cl.index_of(url)][3], name)
                    shutil.copy2(src, aside / name)
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": NETS_COLLECTION,
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
                    dropped.append((vid, sid, url, src, name))
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v in vids),
                "the lookup drops the four shards")

        _, launches["nets.drop_shards"] = counted(drop)

        def read_degraded() -> dict:
            with ThreadPoolExecutor(len(NETS_STORES)) as ex:
                return dict(zip(NETS_STORES, ex.map(
                    lambda kind: fs_check_reads(
                        urls[kind], files, by_store[kind], chunk, seed,
                        ranges=0, threads=2), NETS_STORES)))

        t0 = time.perf_counter()
        rd, launches["nets.read_degraded"] = counted(read_degraded)
        rd_s = time.perf_counter() - t0
        bal_log("nets.read_degraded", rd_s, launches["nets.read_degraded"],
                lost_shards=list(VICTIMS), volumes=vids,
                files=sum(r["files"] for r in rd.values()), bytes=nbytes,
                gbps=nbytes / rd_s / 1e9,
                per_store={k: r["per_file"] for k, r in rd.items()})

        def restore() -> None:
            for vid, sid, url, src, name in dropped:
                shutil.copy2(aside / name, src)
                status, out = http.post_json(
                    f"http://{url}/admin/ec/mount",
                    {"volume_id": vid, "collection": NETS_COLLECTION,
                     "shard_ids": [sid]})
                if status != 200:
                    raise AssertionError(f"restore {vid}.{sid}: {out}")
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 for v in vids),
                "the lookup lists the restored shards")

        _, launches["nets.restore_shards"] = counted(restore)
        shutil.rmtree(aside, ignore_errors=True)

        # (16c) every filer stopped by SIGTERM and started again with its
        # arguments on its fake, all at once; the shell lists the redis2
        # filer's files back
        def restart(kind: str) -> float:
            fs = filers[kind]
            t2 = time.perf_counter()
            before = fs_walk(fs.url, "/")
            fs.stop()
            fs.start()
            wait_until(fs.up, f"the restarted {kind} filer", timeout=120)
            restart_s = time.perf_counter() - t2
            if fs_walk(fs.url, "/") != before:
                raise AssertionError(f"the restarted {kind} filer lists "
                                     f"otherwise")
            one = by_store[kind][0]
            if fs_get(fs.url, one)[0].data != files.data(one):
                raise AssertionError(f"after the {kind} filer's restart: "
                                     f"{one}")
            return restart_s

        def restarts() -> dict:
            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(NETS_STORES)) as ex:
                out = dict(zip(NETS_STORES, ex.map(restart, NETS_STORES)))
            sh = subprocess.run(
                [sys.executable, "-m", "seaweedfs_torch.cli", "shell",
                 "-master", master, "-filer", cli.url, "fs.ls",
                 f"/buckets/nets-{NETS_CLI_STORE}"],
                cwd=str(REPO), capture_output=True, text=True, timeout=120)
            listed = json.loads(sh.stdout.strip().splitlines()[-1])
            if sh.returncode != 0 or listed["entries"] != sorted(
                    p.rsplit("/", 1)[1] for p in by_store[NETS_CLI_STORE]):
                raise AssertionError(f"shell -filer fs.ls: {sh.stderr}")
            return {"restart_s": out, "secs": time.perf_counter() - t1}

        rs, launches["nets.restarts"] = counted(restarts)
        bal_log("nets.restarts", rs.pop("secs"), launches["nets.restarts"],
                **rs)
    finally:
        for fs in filers.values():
            fs.stop()
        if cl is not None:
            cl.shutdown()
        fakes.stop()
    if coder_name == "auto":
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            if others or (step in NETS_CODER_STEPS) != (counts["gf_apply"]
                                                        > 0):
                raise AssertionError(f"{step}: launches {counts}")
    bal_log("nets.summary", time.perf_counter() - t_phase, launches,
            gf_apply_per_step={k: v["gf_apply"] for k, v in launches.items()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


S3P_LIMIT_MB = 64
S3P_WARM_BYTES = 64 * MIB        # arc/ and keep/, half each
S3P_TMP_BYTES = 4 * MIB          # tmp/, expired by the bucket's rule
S3P_MAX_FILE = 8 * MIB           # phase 3's generator: log-uniform 1 KiB ..
S3P_CHUNK = 8 * MIB              # the CLI filer's chunks
S3P_STREAMING = 20               # at least this many streaming PUTs
S3P_STREAM_PIECE = 64 * 1024     # a streaming body's signed chunk
S3P_MULTIPART = 40 * MIB
S3P_PART = 8 * MIB
S3P_COPIES = 20
S3P_FLAT = 1100                  # small keys under flat/
S3P_FLAT_DELETED = 100           # of them, through DeleteObjects
S3P_PAGE = 100                   # ListObjectsV2 max-keys
S3P_VER_KEYS = 200
S3P_VER_DELETED = 50
S3P_VER_MAX = 64 * 1024
S3P_CLIENTS = 8                  # PUT and GET clients ...
S3P_PROCS = 2                    # ... in this many processes
S3P_CODER_STEPS = ("s3.rules", "s3.read_degraded")
S3P_ADMIN = ("S3ADMINKEY", "s3adminsecret")
S3P_READER = ("S3READKEY", "s3readsecret")
S3P_IDENTITIES = [
    {"name": "admin", "credentials": [{"accessKey": S3P_ADMIN[0],
                                       "secretKey": S3P_ADMIN[1]}],
     "actions": ["Admin"]},
    {"name": "reader", "credentials": [{"accessKey": S3P_READER[0],
                                        "secretKey": S3P_READER[1]}],
     "actions": ["Read", "List"]}]
S3P_RULES = (b"<LifecycleConfiguration>"
             b"<Rule><ID>tmp</ID><Filter><Prefix>tmp/</Prefix></Filter>"
             b"<Status>Enabled</Status>"
             b"<Expiration><Days>1</Days></Expiration></Rule>"
             b"<Rule><ID>arc</ID><Filter><Prefix>arc/</Prefix></Filter>"
             b"<Status>Enabled</Status>"
             b"<Transition><Days>0</Days><StorageClass>WARM"
             b"</StorageClass></Transition></Rule>"
             b"</LifecycleConfiguration>")
S3P_XMLNS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def s3_sign(method: str, url: str, headers: dict, content_sha: str,
            akid: str, secret: str, now: float = None) -> tuple:
    """This script's SigV4 signer, independent of the port's: the headers
    to send (every one of them signed) and, for a streaming body's chunk
    chain, the signing key, scope, date and seed signature."""
    import hashlib
    import hmac
    import time
    import urllib.parse

    def mac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    parts = urllib.parse.urlsplit(url)
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(
        time.time() if now is None else now))
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    out = {**headers, "host": parts.netloc, "x-amz-date": amz_date,
           "x-amz-content-sha256": content_sha}
    low = {k.lower(): str(v) for k, v in out.items()}
    signed = sorted(low)
    query = sorted((urllib.parse.quote(k, safe="-_.~"),
                    urllib.parse.quote(v, safe="-_.~"))
                   for k, v in urllib.parse.parse_qsl(
                       parts.query, keep_blank_values=True))
    canonical = "\n".join([
        method, urllib.parse.quote(urllib.parse.unquote(parts.path) or "/",
                                   safe="/-_.~"),
        "&".join(f"{k}={v}" for k, v in query),
        "".join(f"{h}:{' '.join(low[h].split())}\n" for h in signed),
        ";".join(signed), content_sha])
    key = mac(mac(mac(mac(f"AWS4{secret}".encode(), amz_date[:8]),
                      "us-east-1"), "s3"), "aws4_request")
    sig = hmac.new(key, "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()]).encode(),
        hashlib.sha256).hexdigest()
    out["Authorization"] = (f"AWS4-HMAC-SHA256 Credential={akid}/{scope}, "
                            f"SignedHeaders={';'.join(signed)}, "
                            f"Signature={sig}")
    return out, key, scope, amz_date, sig


def s3_chunked(data: bytes, piece: int, key: bytes, seed: str,
               amz_date: str, scope: str) -> bytes:
    """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD body: `piece`-byte chunks,
    each signature chained on the one before, ending with an empty
    chunk."""
    import hashlib
    import hmac
    empty = hashlib.sha256(b"").hexdigest()
    out = bytearray()
    prev = seed
    for at in list(range(0, len(data), piece)) + [len(data)]:
        chunk = data[at:at + piece]
        prev = hmac.new(key, "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev, empty,
            hashlib.sha256(chunk).hexdigest()]).encode(),
            hashlib.sha256).hexdigest()
        out += b"%x;chunk-signature=%s\r\n" % (len(chunk), prev.encode())
        out += chunk + b"\r\n"
    return bytes(out)


# the clients of one process: the job (JSON on stdin) holds the gateway,
# the credentials and groups of ops; each of `threads` threads runs its
# groups in order on its own connection. An op is {"method", "path"} with
# "seed", "nid", "size" for a PUT's body or a GET's expected bytes,
# "stream" for a chunked-SigV4 body and "want" for an expected status.
# One result per op on stdout as JSON: [id, status, seconds, version id,
# bytes equal]
_S3_CLIENT = """
import hashlib, http.client, json, sys, threading, time
import numpy as np
%s
%s
job = json.loads(sys.stdin.read())
host = job["gateway"]
out, lock = [], threading.Lock()

def body_of(op):
    return np.random.default_rng((op["seed"], op["nid"])).bytes(op["size"])

def run(groups):
    conn = http.client.HTTPConnection(host, timeout=600)
    for group in groups:
        for op in group:
            method, url = op["method"], "http://%%s%%s" %% (host, op["path"])
            body = body_of(op) if method == "PUT" and "seed" in op else b""
            if op.get("stream"):
                hdrs, key, scope, amz, sig = s3_sign(
                    method, url, {"x-amz-decoded-content-length":
                                  str(len(body)), "Content-Type":
                                  "application/octet-stream"},
                    "STREAMING-AWS4-HMAC-SHA256-PAYLOAD", *job["who"])
                body = s3_chunked(body, job["piece"], key, sig, amz, scope)
            else:
                hdrs = s3_sign(method, url, {"Content-Type":
                                             "application/octet-stream"},
                               hashlib.sha256(body).hexdigest(),
                               *job["who"])[0]
            t0 = time.perf_counter()
            try:
                conn.request(method, op["path"], body=body or None,
                             headers=hdrs)
                r = conn.getresponse()
                data = r.read()
                status, vid = r.status, r.getheader("x-amz-version-id", "")
            except OSError as e:
                conn.close()
                conn = http.client.HTTPConnection(host, timeout=600)
                status, vid, data = repr(e), "", b""
            secs = time.perf_counter() - t0
            equal = True
            if method == "GET" and "seed" in op:
                equal = hashlib.sha256(data).digest() == hashlib.sha256(
                    body_of(op)).digest()
            with lock:
                out.append([op["id"], status, secs, vid, equal])
    conn.close()

workers = [threading.Thread(target=run, args=(job["groups"][k::job["threads"]],))
           for k in range(job["threads"])]
for w in workers:
    w.start()
for w in workers:
    w.join()
print(json.dumps(out))
"""


def s3_clients(gateway: str, groups: list, who: tuple = S3P_ADMIN,
               clients: int = S3P_CLIENTS) -> tuple:
    """Run `groups` of ops through `clients` clients in S3P_PROCS
    processes; (results by op id, wall seconds)."""
    import inspect
    script = _S3_CLIENT % (inspect.getsource(s3_sign),
                           inspect.getsource(s3_chunked))
    n = 0
    for group in groups:
        for op in group:
            op["id"] = n
            n += 1
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=str(REPO),
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in range(S3P_PROCS)]
    outs = [p.communicate(json.dumps({
        "gateway": gateway, "who": list(who), "piece": S3P_STREAM_PIECE,
        "threads": clients // S3P_PROCS,
        "groups": groups[i::S3P_PROCS]}).encode(), timeout=1200)[0]
        for i, p in enumerate(procs)]
    wall = time.perf_counter() - t0
    got = {}
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"S3 clients exited {p.returncode}")
        for r in json.loads(out.splitlines()[-1]):
            got[r[0]] = r
    if len(got) != n:
        raise AssertionError(f"S3 clients answered {len(got)} of {n} ops")
    return got, wall


class S3Tally:
    """Every answer of the phase: none may be a 5xx."""

    def __init__(self):
        self.statuses = collections.Counter()

    def add(self, status) -> None:
        self.statuses[status] += 1
        if not isinstance(status, int) or status >= 500:
            raise AssertionError(f"S3 answer {status}")


def s3_call(gateway: str, method: str, path: str, body: bytes = b"",
            headers: dict = None, who: tuple = S3P_ADMIN, tally=None):
    """One request signed by s3_sign; the response and its seconds."""
    url = f"http://{gateway}{path}"
    hdrs = s3_sign(method, url, dict(headers or {}),
                   hashlib.sha256(body).hexdigest(), *who)[0]
    t0 = time.perf_counter()
    r = http.request(method, url, body or None, hdrs, timeout=600)
    secs = time.perf_counter() - t0
    if tally is not None:
        tally.add(r.status)
    return r, secs


def s3_presign_v4(gateway: str, path: str, who: tuple,
                  expires: int = 300) -> str:
    """A presigned V4 GET URL (query auth, UNSIGNED-PAYLOAD)."""
    import hmac
    import urllib.parse
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
    q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256",
         "X-Amz-Credential": f"{who[0]}/{scope}", "X-Amz-Date": amz_date,
         "X-Amz-Expires": str(expires), "X-Amz-SignedHeaders": "host"}
    cq = "&".join(f"{urllib.parse.quote(k, safe='-_.~')}="
                  f"{urllib.parse.quote(v, safe='-_.~')}"
                  for k, v in sorted(q.items()))
    canonical = "\n".join(["GET", urllib.parse.quote(path, safe="/-_.~"), cq,
                           f"host:{gateway}\n", "host", "UNSIGNED-PAYLOAD"])
    key = s3_sign("GET", f"http://{gateway}/", {}, "", *who)[1]
    sig = hmac.new(key, "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()]).encode(),
        hashlib.sha256).hexdigest()
    return f"http://{gateway}{path}?{cq}&X-Amz-Signature={sig}"


def s3_presign_v2(gateway: str, path: str, who: tuple,
                  expires: int = 300) -> str:
    """A presigned V2 GET URL: Base64(HMAC-SHA1) of the method, the epoch
    expiry and the resource."""
    import base64
    import hmac
    import urllib.parse
    until = str(int(time.time()) + expires)
    sig = base64.b64encode(hmac.new(
        who[1].encode(), f"GET\n\n\n{until}\n{path}".encode(),
        hashlib.sha1).digest()).decode()
    return (f"http://{gateway}{path}?" + urllib.parse.urlencode(
        {"AWSAccessKeyId": who[0], "Expires": until, "Signature": sig}))


def s3_xml(data: bytes):
    import xml.etree.ElementTree as ET
    return ET.fromstring(data)


def s3_list(gateway: str, bucket: str, tally, **params) -> tuple:
    """ListObjectsV2 paged by continuation token: (keys, common prefixes,
    storage classes, seconds per page, page sizes)."""
    import urllib.parse
    keys, prefixes, classes, lat, sizes = [], [], {}, [], []
    token = ""
    while True:
        q = {"list-type": "2", **params}
        if token:
            q["continuation-token"] = token
        r, secs = s3_call(gateway, "GET", f"/{bucket}?"
                          + urllib.parse.urlencode(q), tally=tally)
        if r.status != 200:
            raise AssertionError(f"list {bucket} {q}: {r.status}")
        root = s3_xml(r.data)
        page = [c.find(f"{S3P_XMLNS}Key").text
                for c in root.findall(f"{S3P_XMLNS}Contents")]
        for c in root.findall(f"{S3P_XMLNS}Contents"):
            classes[c.find(f"{S3P_XMLNS}Key").text] = c.find(
                f"{S3P_XMLNS}StorageClass").text
        cps = [p.find(f"{S3P_XMLNS}Prefix").text
               for p in root.findall(f"{S3P_XMLNS}CommonPrefixes")]
        keys += page
        prefixes += cps
        lat.append(secs)
        sizes.append(len(page) + len(cps))
        if root.find(f"{S3P_XMLNS}IsTruncated").text != "true":
            return keys, prefixes, classes, lat, sizes
        token = root.find(f"{S3P_XMLNS}NextContinuationToken").text


def run_s3(work: Path, seed: int = SEED + 17, coder_name: str = "auto",
           device=None, limit_mb: int = S3P_LIMIT_MB,
           warm_bytes: int = S3P_WARM_BYTES, tmp_bytes: int = S3P_TMP_BYTES,
           max_file: int = S3P_MAX_FILE, chunk: int = S3P_CHUNK,
           multipart: int = S3P_MULTIPART, part: int = S3P_PART,
           copies: int = S3P_COPIES, flat: int = S3P_FLAT,
           flat_deleted: int = S3P_FLAT_DELETED, page: int = S3P_PAGE,
           ver_keys: int = S3P_VER_KEYS,
           ver_deleted: int = S3P_VER_DELETED) -> dict:
    """Phase 17; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 17d's warm-down and degraded reads
    only; no other kernel); ``coder_name="torch", device="cpu"`` at a few
    MB runs it on a host without one (no launch is counted there; `chunk`
    and `part` whole MiB, as the CLI filer takes them)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.balance import BalanceConfig
    from seaweedfs_torch.lifecycle import s3_rules
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    tally = S3Tally()
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    filer_port = free_port()
    with env_set(WEED_LIFECYCLE_FILER=f"127.0.0.1:{filer_port}",
                 WEED_LIFECYCLE_INTERVAL="0.5",
                 WEED_LIFECYCLE_DAY_SECONDS="1",
                 WEED_LIFECYCLE_WARM_AFTER=None,
                 WEED_LIFECYCLE_HOT_READ_RATE=None,
                 WEED_LIFECYCLE_COLLECTION_TTL=None):
        lc_cfg = LifecycleConfig.from_env()
    cl = LocalCluster(2, coder_name=coder_name, device=device,
                      volume_size_limit_mb=limit_mb, pulse=0.5,
                      directory=str(work / "cluster"), racks=2,
                      master_kwargs={"repair_enabled": False,
                                     "lifecycle_config": lc_cfg,
                                     "balance_config": BalanceConfig(
                                         force_enabled=False)})
    master = cl.master_url
    config = work / "s3.json"
    config.write_text(json.dumps({"identities": S3P_IDENTITIES}))
    filer = CliFiler(work, [
        "filer", "-mserver", master, "-store", "leveldb2", "-store_path",
        str(work / "filer_leveldb2"), "-chunk_size_mb", cli_chunk_mb(chunk)],
        port=filer_port)
    gw = CliFiler(work, ["s3", "-filer", filer.url, "-config", str(config)],
                  name="s3")
    daemon = cl.master.lifecycle

    def ops_of(paths: list, method: str = "GET", **extra) -> list:
        return [[{"method": method, "path": p, "seed": seed,
                  "nid": files.files[p][0], "size": files.files[p][1],
                  **extra}] for p in paths]

    # (key, nid) of every PUT the gateway acknowledged, and of every
    # object version a GET read back with its bytes
    written: set = set()
    verified: set = set()

    def acked(got: dict, groups: list, want: int, what: str) -> list:
        lat = []
        for group in groups:
            for op in group:
                _, status, secs, _, equal = got[op["id"]]
                tally.add(status)
                if status != want or not equal:
                    raise AssertionError(f"{what} {op['method']} "
                                         f"{op['path']}: {status}, bytes "
                                         f"equal {equal}")
                lat.append(secs)
                if "nid" in op and status == 200:
                    (written if op["method"] == "PUT" else verified).add(
                        (op["path"].split("?")[0], op["nid"]))
        return lat

    try:
        filer.start()
        wait_until(filer.up, "the CLI filer", timeout=120)
        gw.start()
        wait_until(gw.up, "the CLI gateway", timeout=120)
        for bucket in ("warm", "ver"):
            r, _ = s3_call(gw.url, "PUT", f"/{bucket}", tally=tally)
            if r.status != 200:
                raise AssertionError(f"PUT /{bucket}: {r.status}")
        log({"phase": "s3.setup", "seconds": time.perf_counter() - t_phase,
             "filer": filer.url, "gateway": gw.url, "card": SMI[0]})

        # (17a) arc/, keep/ and tmp/ through the clients, every other PUT
        # a streaming chunked-SigV4 body; every object read back
        for sub, total in (("arc", warm_bytes // 2),
                           ("keep", warm_bytes - warm_bytes // 2),
                           ("tmp", tmp_bytes)):
            for i, size in enumerate(fs_sizes(rng, total, 1024, max_file)):
                files.add(f"/warm/{sub}/f{i:04d}.bin", size)
        warm = list(files.files)
        puts = ops_of(warm, "PUT")
        for k, group in enumerate(puts):
            group[0]["stream"] = k % 2 == 0 or k < S3P_STREAMING
        streamed = sum(g[0]["stream"] for g in puts)
        if streamed < min(S3P_STREAMING, len(puts)):
            raise AssertionError(f"{streamed} streaming PUTs")

        def put() -> dict:
            got, wall = s3_clients(gw.url, puts)
            return {"lat": acked(got, puts, 200, "warm"), "wall": wall}

        up, launches["s3.put"] = counted(put)
        nbytes = sum(files.files[p][1] for p in warm)
        bal_log("s3.put", up["wall"], launches["s3.put"], objects=len(warm),
                bytes=nbytes, streaming_puts=streamed,
                gbps=nbytes / up["wall"] / 1e9,
                per_object=latency_summary(up["lat"]))
        gets = ops_of(warm)

        def get() -> dict:
            got, wall = s3_clients(gw.url, gets)
            return {"lat": acked(got, gets, 200, "warm"), "wall": wall}

        rd, launches["s3.get"] = counted(get)
        bal_log("s3.get", rd["wall"], launches["s3.get"], objects=len(warm),
                gbps=nbytes / rd["wall"] / 1e9,
                per_object=latency_summary(rd["lat"]))

        # (17b) multipart, copies, flat/ with a bulk delete, listings,
        # presigned GETs, the reader refused
        def multipart_upload() -> dict:
            key = "/warm/big/mp.bin"
            data = files.add(key, multipart)
            t0 = time.perf_counter()
            r, _ = s3_call(gw.url, "POST", f"{key}?uploads", tally=tally)
            upload = s3_xml(r.data).find(f"{S3P_XMLNS}UploadId").text
            pieces = [data[i:i + part] for i in range(0, len(data), part)]

            def one(n: int) -> str:
                r, _ = s3_call(gw.url, "PUT", f"{key}?partNumber={n}"
                               f"&uploadId={upload}", pieces[n - 1],
                               tally=tally)
                if r.status != 200:
                    raise AssertionError(f"part {n}: {r.status}")
                return r.headers["ETag"]

            with ThreadPoolExecutor(len(pieces)) as ex:
                etags = list(ex.map(one, range(1, len(pieces) + 1)))
            r, _ = s3_call(gw.url, "GET", f"{key}?uploadId={upload}",
                           tally=tally)
            listed = [(int(p.find(f"{S3P_XMLNS}PartNumber").text),
                       int(p.find(f"{S3P_XMLNS}Size").text),
                       p.find(f"{S3P_XMLNS}ETag").text)
                      for p in s3_xml(r.data).findall(f"{S3P_XMLNS}Part")]
            if listed != [(n + 1, len(pc), e) for n, (pc, e) in
                          enumerate(zip(pieces, etags))]:
                raise AssertionError(f"ListParts: {listed}")
            body = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
            r, _ = s3_call(gw.url, "POST", f"{key}?uploadId={upload}",
                           body.encode(), tally=tally)
            secs = time.perf_counter() - t0
            want = '"%s-%d"' % (hashlib.md5(upload.encode()).hexdigest(),
                                len(pieces))
            etag = s3_xml(r.data).find(f"{S3P_XMLNS}ETag").text
            if r.status != 200 or etag != want:
                raise AssertionError(f"complete: {r.status} {etag}")
            written.add((key, files.files[key][0]))
            r, get_s = s3_call(gw.url, "GET", key, tally=tally)
            if hashlib.sha256(r.data).digest() != hashlib.sha256(
                    data).digest():
                raise AssertionError("the multipart object reads back "
                                     "wrong")
            verified.add((key, files.files[key][0]))
            return {"seconds": secs, "parts": len(pieces),
                    "gbps": len(data) / secs / 1e9, "get_s": get_s}

        mp, launches["s3.multipart"] = counted(multipart_upload)
        bal_log("s3.multipart", mp.pop("seconds"), launches["s3.multipart"],
                bytes=multipart, **mp)

        keep = files.under("/warm/keep/")
        for i, size in enumerate(int(x) for x in rng.integers(
                16, 512, size=flat)):
            files.add(f"/warm/flat/k{i:05d}", size)
        flat_keys = files.under("/warm/flat/")
        gone = sorted(str(k) for k in rng.choice(flat_keys, flat_deleted,
                                                 replace=False))

        def copy_flat_delete() -> dict:
            def copy(src: str) -> None:
                dst = src.replace("/keep/", "/copies/")
                r, _ = s3_call(gw.url, "PUT", dst, headers={
                    "x-amz-copy-source": src}, tally=tally)
                if r.status != 200:
                    raise AssertionError(f"copy {src}: {r.status}")
                files.files[dst] = files.files[src]
                written.add((dst, files.files[dst][0]))

            t0 = time.perf_counter()
            with ThreadPoolExecutor(S3P_CLIENTS) as ex:
                list(ex.map(copy, keep[:copies]))
            copy_s = time.perf_counter() - t0
            groups = ops_of(flat_keys, "PUT")
            got, flat_s = s3_clients(gw.url, groups)
            acked(got, groups, 200, "flat")
            body = "<Delete>" + "".join(
                f"<Object><Key>{k[len('/warm/'):]}</Key></Object>"
                for k in gone) + "</Delete>"
            r, del_s = s3_call(gw.url, "POST", "/warm?delete",
                               body.encode(), tally=tally)
            deleted = sorted("/warm/" + d.find(f"{S3P_XMLNS}Key").text
                             for d in s3_xml(r.data).findall(
                                 f"{S3P_XMLNS}Deleted"))
            if deleted != gone:
                raise AssertionError(f"DeleteObjects: {len(deleted)} of "
                                     f"{len(gone)}")
            for k in gone:
                written.discard((k, files.files.pop(k)[0]))
            # every copy and every small key left read back by sha256
            kept = ops_of(files.under("/warm/copies/")
                          + files.under("/warm/flat/"))
            got, read_s = s3_clients(gw.url, kept)
            acked(got, kept, 200, "copies and flat/")
            return {"secs": time.perf_counter() - t0, "copy_s": copy_s,
                    "read_back_s": read_s,
                    "flat_put_s": flat_s,
                    "flat_puts_per_s": len(flat_keys) / flat_s,
                    "delete_objects_s": del_s}

        cf, launches["s3.copy_delete"] = counted(copy_flat_delete)
        bal_log("s3.copy_delete", cf.pop("secs"),
                launches["s3.copy_delete"], copies=copies,
                flat_keys=len(flat_keys), deleted=len(gone), **cf)

        def listings() -> dict:
            want = sorted(k[len("/warm/flat/"):]
                          for k in files.under("/warm/flat/"))
            keys, cps, _, lat, sizes = s3_list(
                gw.url, "warm", tally, prefix="flat/", delimiter="/",
                **{"max-keys": str(page)})
            if [k[len("flat/"):] for k in keys] != want or cps or \
                    max(sizes) > page:
                raise AssertionError(f"flat/ lists {len(keys)} keys, want "
                                     f"{len(want)}")
            keys2, cps2, _, lat2, _ = s3_list(gw.url, "warm", tally,
                                              delimiter="/")
            top = sorted({p.split("/")[2] + "/" for p in files.files
                          if p.startswith("/warm/")})
            if keys2 or cps2 != top:
                raise AssertionError(f"the root lists {keys2} {cps2}, "
                                     f"want {top}")
            return {"lat": lat + lat2, "pages": len(lat),
                    "keys": len(keys)}

        ls, launches["s3.list"] = counted(listings)
        bal_log("s3.list", sum(ls["lat"]), launches["s3.list"],
                listed_keys=ls["keys"], pages=ls["pages"], page=page,
                per_page=latency_summary(ls["lat"]))

        def presigned() -> dict:
            one = keep[0]
            want = files.data(one)
            out = {}
            for name, url in (("v4", s3_presign_v4(gw.url, one, S3P_READER)),
                              ("v2", s3_presign_v2(gw.url, one,
                                                   S3P_READER))):
                r = http.request("GET", url, timeout=600)
                tally.add(r.status)
                if r.status != 200 or r.data != want:
                    raise AssertionError(f"presigned {name}: {r.status}")
                out[name] = r.status
            r, _ = s3_call(gw.url, "PUT", "/warm/keep/reader.bin", b"no",
                           who=S3P_READER, tally=tally)
            if r.status != 403 or b"AccessDenied" not in r.data:
                raise AssertionError(f"the reader's PUT: {r.status}")
            r, _ = s3_call(gw.url, "GET", one, who=S3P_READER, tally=tally)
            if r.data != want:
                raise AssertionError("the reader's GET")
            return {"presigned": out, "reader_put": 403}

        t0 = time.perf_counter()
        pr, launches["s3.presigned"] = counted(presigned)
        bal_log("s3.presigned", time.perf_counter() - t0,
                launches["s3.presigned"], **pr)

        # (17c) the ver bucket: each key written twice, some deleted,
        # every old version read by id, the versions listed
        r, _ = s3_call(gw.url, "PUT", "/ver?versioning",
                       b"<VersioningConfiguration><Status>Enabled</Status>"
                       b"</VersioningConfiguration>", tally=tally)
        if r.status != 200:
            raise AssertionError(f"versioning: {r.status}")
        first, second = {}, {}
        for i in range(ver_keys):
            for store in (first, second):
                size = int(np.exp(rng.uniform(np.log(1024),
                                              np.log(S3P_VER_MAX))))
                key = f"/ver/v{i:03d}"
                nid = files.next_nid
                files.next_nid += 1
                store[key] = (nid, size)
        dead = sorted(str(k) for k in rng.choice(sorted(first), ver_deleted,
                                                 replace=False))

        def versioning() -> dict:
            t0 = time.perf_counter()
            groups = [[{"method": "PUT", "path": k, "seed": seed,
                        "nid": v[0], "size": v[1]} for v in (first[k],
                                                              second[k])]
                      for k in sorted(first)]
            got, put_s = s3_clients(gw.url, groups)
            acked(got, groups, 200, "ver")
            vids = {g[0]["path"]: (got[g[0]["id"]][3], got[g[1]["id"]][3])
                    for g in groups}
            if any(not a or not b or a >= b for a, b in vids.values()):
                raise AssertionError("version ids not time-ordered")
            dels = [[{"method": "DELETE", "path": k}] for k in dead]
            got, _ = s3_clients(gw.url, dels)
            acked(got, dels, 204, "ver delete")
            markers = {g[0]["path"]: got[g[0]["id"]][3] for g in dels}
            reads = ([[{"method": "GET", "path": f"{k}?versionId="
                        f"{vids[k][0]}", "seed": seed, "nid": first[k][0],
                        "size": first[k][1]}] for k in sorted(first)]
                     + [[{"method": "GET", "path": f"{k}?versionId="
                          f"{vids[k][1]}" if k in markers else k,
                          "seed": seed, "nid": second[k][0],
                          "size": second[k][1]}] for k in sorted(first)])
            got, _ = s3_clients(gw.url, reads)
            old_lat = acked(got, reads, 200, "ver read")
            gone_ = [[{"method": "GET", "path": k}] for k in dead]
            got, _ = s3_clients(gw.url, gone_)
            acked(got, gone_, 404, "a deleted ver key")
            r, list_s = s3_call(gw.url, "GET", "/ver?versions&max-keys=1000",
                                tally=tally)
            root = s3_xml(r.data)
            seen = {}
            for el in root:
                tag = el.tag[len(S3P_XMLNS):]
                if tag not in ("Version", "DeleteMarker"):
                    continue
                key = "/ver/" + el.find(f"{S3P_XMLNS}Key").text
                seen.setdefault(key, []).append((
                    tag, el.find(f"{S3P_XMLNS}VersionId").text,
                    el.find(f"{S3P_XMLNS}IsLatest").text))
            for k in first:
                want = [("Version", vids[k][1], "false"),
                        ("Version", vids[k][0], "false")]
                if k in markers:
                    want.insert(0, ("DeleteMarker", markers[k], "true"))
                else:
                    want[0] = ("Version", vids[k][1], "true")
                if seen.get(k) != want:
                    raise AssertionError(f"versions of {k}: {seen.get(k)}, "
                                         f"want {want}")
            return {"secs": time.perf_counter() - t0, "put_s": put_s,
                    "versions": 2 * len(first), "markers": len(markers),
                    "old_reads": latency_summary(old_lat),
                    "list_versions_s": list_s}

        vs, launches["s3.versioning"] = counted(versioning)
        bal_log("s3.versioning", vs.pop("secs"), launches["s3.versioning"],
                keys=ver_keys, deleted=ver_deleted, **vs)

        # (17d) the bucket's rules through the gateway: arc/ warms down on
        # the card, tmp/ expires; then reads with 4 shards lost
        def fids(prefix: str) -> dict:
            return {p: [c["fid"] for c in fs_meta(
                filer.url, "lookup", path=f"/buckets{p}")["chunks"]]
                for p in files.under(prefix)}

        arc_fids = fids("/warm/arc/")
        arc_vids = sorted({int(f.split(",")[0]) for fl in arc_fids.values()
                           for f in fl})
        tmp_paths = files.under("/warm/tmp/")
        tmp_fids = [f for fl in fids("/warm/tmp/").values() for f in fl]
        records: list = []
        real_record = daemon._record

        def record(kind, vid, outcome, **kw):
            records.append((time.monotonic(), kind, vid, outcome))
            return real_record(kind, vid, outcome, **kw)

        def warm_ok() -> dict:
            return {r[2]: r[0] for r in list(records)
                    if r[1] == "warm" and r[3] == "ok"}

        def rules() -> dict:
            daemon._record = record
            try:
                t0 = time.monotonic()
                r, _ = s3_call(gw.url, "PUT", "/warm?lifecycle", S3P_RULES,
                               tally=tally)
                if r.status != 200:
                    raise AssertionError(f"lifecycle: {r.status} {r.data}")
                r, _ = s3_call(gw.url, "GET", "/warm?lifecycle",
                               tally=tally)
                if r.data != s3_rules.rules_to_xml(
                        s3_rules.parse_lifecycle_xml(S3P_RULES)):
                    raise AssertionError(f"lifecycle reads {r.data!r}")
                wait_until(lambda: set(arc_vids) <= set(warm_ok()),
                           "the daemon's warm-downs of the arc/ volumes",
                           timeout=600)
                wait_until(lambda: all(s3_call(
                    gw.url, "GET", p, tally=tally)[0].status == 404
                    for p in tmp_paths), "tmp/ expired", timeout=120)
                freed_s = fs_wait_freed(master, tmp_fids, "tmp/ chunks")
            finally:
                daemon._record = real_record
            return {"t0": t0, "freed_s": freed_s,
                    "secs": time.monotonic() - t0}

        rs, launches["s3.rules"] = counted(rules)
        oks = warm_ok()
        for p in tmp_paths:
            files.files.pop(p)
        _, _, classes, _, _ = s3_list(gw.url, "warm", tally, prefix="arc/")
        if set(classes) != {p[len("/warm/"):] for p in arc_fids} or set(
                classes.values()) != {s3_rules.WARM_CLASS}:
            raise AssertionError(f"arc/ lists {sorted(set(classes.values()))}")
        for vid in arc_vids:
            shards = http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
            holders = [i for i in range(len(cl.nodes))
                       if cl.store(i).find_volume(vid) is not None]
            if len(shards.get("shards", {})) != 14 or holders:
                raise AssertionError(f"volume {vid}: shards {shards}, "
                                     f"normal copies on {holders}")
        bal_log("s3.rules", rs["secs"], launches["s3.rules"],
                warm_volumes=len(arc_vids),
                first_warm_s=min(oks[v] for v in arc_vids) - rs["t0"],
                last_warm_s=max(oks[v] for v in arc_vids) - rs["t0"],
                expired=len(tmp_paths), tmp_chunks_freed=len(tmp_fids),
                tmp_freed_s=rs["freed_s"],
                failed_records=[r[1:] for r in records if r[3] != "ok"][:5],
                s3_records=sum(r[1].startswith("s3_") for r in records))

        aside = work / "aside"
        aside.mkdir()
        dropped: list = []

        def drop() -> None:
            for vid in arc_vids:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    name = f"{vid}{geometry.to_ext(sid)}"
                    src = os.path.join(cl.nodes[cl.index_of(url)][3], name)
                    shutil.copy2(src, aside / name)
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": "",
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
                    dropped.append((vid, sid, url, src, name))
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v in arc_vids),
                "the lookup drops the four shards")

        _, launches["s3.drop_shards"] = counted(drop)
        readable = files.under("/warm/arc/") + files.under("/warm/keep/")
        degraded = ops_of(readable)

        def read_degraded() -> dict:
            got, wall = s3_clients(gw.url, degraded)
            return {"lat": acked(got, degraded, 200, "degraded"),
                    "wall": wall}

        dg, launches["s3.read_degraded"] = counted(read_degraded)
        dbytes = sum(files.files[p][1] for p in readable)
        bal_log("s3.read_degraded", dg["wall"], launches["s3.read_degraded"],
                lost_shards=list(VICTIMS), volumes=arc_vids,
                objects=len(readable), bytes=dbytes,
                gbps=dbytes / dg["wall"] / 1e9,
                per_object=latency_summary(dg["lat"]))

        def restore() -> None:
            for vid, sid, url, src, name in dropped:
                shutil.copy2(aside / name, src)
                status, out = http.post_json(
                    f"http://{url}/admin/ec/mount",
                    {"volume_id": vid, "collection": "",
                     "shard_ids": [sid]})
                if status != 200:
                    raise AssertionError(f"restore {vid}.{sid}: {out}")
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 for v in arc_vids),
                "the lookup lists the restored shards")

        _, launches["s3.restore_shards"] = counted(restore)
        shutil.rmtree(aside, ignore_errors=True)
    finally:
        gw.stop()
        filer.stop()
        cl.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            if others or (step in S3P_CODER_STEPS) != (counts["gf_apply"]
                                                       > 0):
                raise AssertionError(f"{step}: launches {counts}")
    lost = sorted(written - verified)
    if lost:
        raise AssertionError(f"{len(lost)} acknowledged PUTs never read "
                             f"back, {lost[:3]}")
    bal_log("s3.summary", time.perf_counter() - t_phase, launches,
            answers=dict(tally.statuses), acknowledged_puts=len(written),
            acknowledged_puts_lost=len(lost),
            gf_apply_per_step={k: v["gf_apply"] for k, v in launches.items()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 18: the filer's client surfaces --------------------------------

DAV_LIMIT_MB = 64
DAV_CHUNK = 8 * MIB              # the CLI filer's chunks, and the mount's
DAV_MAX_FILE = 8 * MIB           # phase 3's generator: log-uniform 1 KiB ..
DAV_BYTES = 24 * MIB             # WebDAV PUTs ...
DAV_DIRS = 20                    # ... under this many collections (MKCOL)
DAV_MOVES = 20
DAV_LOCKS = 10
DAV_CLIENTS = 8                  # WebDAV clients ...
DAV_PROCS = 2                    # ... in this many processes
MNT_BYTES = 16 * MIB             # the in-process mount's files
MNT_PIECE = (4 * 1024, MIB)      # its writes, log-uniform
MNT_THREADS = 4
MNT_XATTRS = 5
MNT_LINKS = 5
FSS_BYTES = 8 * MIB              # through the fsspec adapter
QRY_DOCS = 2000                  # JSON documents for /admin/query ...
QRY_DOC = (200, 4 * 1024)        # ... of this many bytes, log-uniform
QRY_COLLECTION = "docs"
QRY_THREADS = 16                 # the client's upload threads
KMNT_FILES = 3                   # files copied in through a kernel mount
DAV_CODER_STEPS = ("dav.ec_encode", "dav.read_webdav", "dav.read_mount",
                   "dav.read_fsspec", "dav.read_kernel",
                   "dav.query_degraded")
DAV_QUERIES = (
    ({"field": "n", "op": "<", "value": 500}, ["id", "n"]),
    ({"field": "a.b", "op": "=", "value": 7}, ["id", "a.b"]),
    ({"field": "tag", "op": "contains", "value": "x"}, ["id", "tag"]))
DAV_LOCKINFO = (b'<?xml version="1.0" encoding="utf-8"?>'
                b'<D:lockinfo xmlns:D="DAV:"><D:lockscope><D:exclusive/>'
                b'</D:lockscope><D:locktype><D:write/></D:locktype>'
                b'</D:lockinfo>')

# the WebDAV clients of one process: the job (JSON on stdin) holds the
# gateway and lists of ops; each of `threads` threads runs its lists in
# order on its own connection. An op is {"method", "path"} with "seed",
# "nid", "size" for a PUT's body or a GET's expected bytes. One result
# per op on stdout as JSON: [id, status, seconds, bytes equal]
_DAV_CLIENT = """
import hashlib, http.client, json, sys, threading, time
import numpy as np
job = json.loads(sys.stdin.read())
host = job["gateway"]
out, lock = [], threading.Lock()

def body_of(op):
    return np.random.default_rng((op["seed"], op["nid"])).bytes(op["size"])

def run(groups):
    conn = http.client.HTTPConnection(host, timeout=600)
    for group in groups:
        for op in group:
            body = body_of(op) if op["method"] == "PUT" else None
            t0 = time.perf_counter()
            try:
                conn.request(op["method"], op["path"], body=body,
                             headers=op.get("headers", {}))
                r = conn.getresponse()
                data = r.read()
                status = r.status
            except OSError as e:
                conn.close()
                conn = http.client.HTTPConnection(host, timeout=600)
                status, data = repr(e), b""
            secs = time.perf_counter() - t0
            equal = True
            if op["method"] == "GET":
                equal = hashlib.sha256(data).digest() == hashlib.sha256(
                    body_of(op)).digest()
            with lock:
                out.append([op["id"], status, secs, equal])
    conn.close()

workers = [threading.Thread(target=run, args=(job["groups"][k::job["threads"]],))
           for k in range(job["threads"])]
for w in workers:
    w.start()
for w in workers:
    w.join()
print(json.dumps(out))
"""

# a one-directory in-memory filesystem through the port's libfuse2
# binding: whether this host's kernel serves a FUSE mount at all
_FUSE_PROBE = """
import errno, stat, sys
from seaweedfs_torch.mount.fuse_ctypes import fuse_main


class ProbeFS:
    def __init__(self):
        self.files = {}
        self.cur = None

    def getattr(self, path):
        if path == "/":
            return {"mode": stat.S_IFDIR | 0o755, "nlink": 2}
        if path not in self.files:
            raise OSError(errno.ENOENT, path)
        return {"mode": stat.S_IFREG | 0o644, "size": len(self.files[path])}

    def readdir(self, path):
        return [p[1:] for p in self.files]

    def create(self, path, mode):
        self.files[path] = b""
        self.cur = path
        return 1

    def open(self, path, for_write=False):
        if path not in self.files:
            raise OSError(errno.ENOENT, path)
        self.cur = path
        return 1

    def read(self, fh, size, offset):
        return self.files[self.cur][offset:offset + size]

    def write(self, fh, data, offset):
        cur = self.files[self.cur].ljust(offset, b"\\0")
        self.files[self.cur] = cur[:offset] + data + cur[offset + len(data):]
        return len(data)

    def truncate(self, path, length):
        self.files[path] = self.files.get(path, b"")[:length]

    def flush(self, fh):
        pass

    def release(self, fh):
        self.cur = None


sys.exit(fuse_main(sys.argv[1], ProbeFS()))
"""


def fuse_usable() -> str:
    """'' when this host can serve a FUSE mount (the reference's
    predicate: /dev/fuse, libfuse, fusermount, uid 0), else why not."""
    import ctypes.util
    if not os.path.exists("/dev/fuse"):
        return "no /dev/fuse"
    if ctypes.util.find_library("fuse") is None:
        return "no libfuse"
    if shutil.which("fusermount") is None:
        return "no fusermount"
    if os.getuid() != 0:
        return "not uid 0"
    return ""


def fuse_wait(proc, mnt: Path, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.ismount(mnt):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.1)
    return os.path.ismount(mnt)


def fuse_unmount(proc, mnt: Path) -> None:
    subprocess.run(["fusermount", "-u", "-z", str(mnt)],
                   stderr=subprocess.DEVNULL, timeout=30)
    if proc is not None:
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def fuse_probe(work: Path) -> str:
    """'' when a probe filesystem mounts and a file written through it
    reads back, else why not."""
    why = fuse_usable()
    if why:
        return why
    mnt = work / "fuse_probe"
    mnt.mkdir()
    proc = subprocess.Popen([sys.executable, "-c", _FUSE_PROBE, str(mnt)],
                            cwd=str(REPO), stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        if not fuse_wait(proc, mnt, 15.0):
            return "the probe filesystem did not mount"
        (mnt / "probe.txt").write_bytes(b"ping")
        if (mnt / "probe.txt").read_bytes() != b"ping":
            return "the probe filesystem read back wrong"
        return ""
    except OSError as e:
        return f"the probe filesystem failed: {e!r}"
    finally:
        fuse_unmount(proc, mnt)


def dav_clients(gateway: str, groups: list) -> tuple:
    """Run `groups` of ops through DAV_CLIENTS clients in DAV_PROCS
    processes; (results by op id, wall seconds)."""
    n = 0
    for group in groups:
        for op in group:
            op["id"] = n
            n += 1
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _DAV_CLIENT],
                              cwd=str(REPO), stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE)
             for _ in range(DAV_PROCS)]
    outs = [p.communicate(json.dumps({
        "gateway": gateway, "threads": DAV_CLIENTS // DAV_PROCS,
        "groups": groups[i::DAV_PROCS]}).encode(), timeout=1200)[0]
        for i, p in enumerate(procs)]
    wall = time.perf_counter() - t0
    got = {}
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"WebDAV clients exited {p.returncode}")
        for r in json.loads(out.splitlines()[-1]):
            got[r[0]] = r
    if len(got) != n:
        raise AssertionError(f"WebDAV clients answered {len(got)} of {n}")
    return got, wall


def dav_call(gateway: str, method: str, path: str, body: bytes = b"",
             headers: dict = None, tally=None):
    """One WebDAV request from this process; the response and its
    seconds."""
    t0 = time.perf_counter()
    r = http.request(method, f"http://{gateway}{path}", body or None,
                     dict(headers or {}), timeout=600)
    if tally is not None:
        tally.add(r.status)
    return r, time.perf_counter() - t0


def dav_propfind(gateway: str, path: str, tally) -> tuple:
    """{href: content length (None for a collection)} of a depth-1
    PROPFIND, and its seconds."""
    import xml.etree.ElementTree as ET
    r, secs = dav_call(gateway, "PROPFIND", path, headers={"Depth": "1"},
                       tally=tally)
    if r.status != 207:
        raise AssertionError(f"PROPFIND {path}: {r.status}")
    out = {}
    for resp in ET.fromstring(r.data).findall("{DAV:}response"):
        href = resp.find("{DAV:}href").text
        length = resp.find(".//{DAV:}getcontentlength")
        out[href] = None if length is None else int(length.text)
    return out, secs


def mount_pieces(rng, size: int, nid0: int) -> list:
    """(offset, nid, size) writes that cover [0, size) in pieces of
    MNT_PIECE bytes, plus a quarter as many overlapping ones, all in a
    seeded order; nids from nid0 up."""
    lo, hi = MNT_PIECE
    pieces, at = [], 0
    while at < size:
        n = min(size - at, int(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        pieces.append((at, n))
        at += n
    for _ in range(max(1, len(pieces) // 4)):
        n = min(size, int(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
        pieces.append((int(rng.integers(0, size - n + 1)), n))
    order = rng.permutation(len(pieces))
    return [(pieces[i][0], nid0 + k, pieces[i][1])
            for k, i in enumerate(order)]


def dav_fids(filer: str, paths: list) -> dict:
    """path -> its chunks' fids, through the filer's meta API."""
    return {p: [c["fid"] for c in fs_meta(filer, "lookup", path=p)["chunks"]]
            for p in paths}


def run_dav(work: Path, seed: int = SEED + 18, coder_name: str = "auto",
            device=None, limit_mb: int = DAV_LIMIT_MB,
            dav_bytes: int = DAV_BYTES, dav_dirs: int = DAV_DIRS,
            moves: int = DAV_MOVES, locks: int = DAV_LOCKS,
            mount_bytes: int = MNT_BYTES, fsspec_bytes: int = FSS_BYTES,
            docs: int = QRY_DOCS, max_file: int = DAV_MAX_FILE,
            chunk: int = DAV_CHUNK, kernel_mount: bool = True) -> dict:
    """Phase 18; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in 18's encode and in each read with 4
    shards lost whose files have a needle on a lost shard; no other
    kernel); ``coder_name="torch", device="cpu"`` at a few MB runs it on
    a host without one (no launch is counted there; `chunk` whole MiB,
    as the CLI filer takes it)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.balance import BalanceConfig
    from seaweedfs_torch.filer.assign_lease import AssignLeasePool
    from seaweedfs_torch.mount import wfs as wfs_mod
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    tally = S3Tally()
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    cl = LocalCluster(2, coder_name=coder_name, device=device,
                      volume_size_limit_mb=limit_mb, pulse=0.5,
                      directory=str(work / "cluster"), racks=2,
                      master_kwargs={"repair_enabled": False,
                                     "balance_config": BalanceConfig(
                                         force_enabled=False)})
    master = cl.master_url
    filer = CliFiler(work, [
        "filer", "-mserver", master, "-store", "leveldb2", "-store_path",
        str(work / "filer_leveldb2"), "-chunk_size_mb", cli_chunk_mb(chunk)])
    gw = CliFiler(work, ["webdav", "-filer", filer.url], name="webdav")
    kmnt = work / "kmnt"
    kproc = None
    wfs = None
    fss = None
    # each surface's paths, and the mount's bytes as the plain reference
    surfaces: dict = {"webdav": [], "mount": [], "fsspec": [], "kernel": []}
    model: dict = {}
    try:
        filer.start()
        wait_until(filer.up, "the CLI filer", timeout=120)
        gw.start()
        wait_until(gw.up, "the CLI WebDAV gateway", timeout=120)
        log({"phase": "dav.setup", "seconds": time.perf_counter() - t_phase,
             "filer": filer.url, "webdav": gw.url, "card": SMI[0]})

        # (18a) WebDAV: MKCOL, PUTs by the clients, MOVE, COPY, PROPFIND
        colls = [f"/dav/c{i:02d}" for i in range(dav_dirs)]

        def mkcol() -> None:
            for p in ["/dav"] + colls:
                r, _ = dav_call(gw.url, "MKCOL", p, tally=tally)
                if r.status != 201:
                    raise AssertionError(f"MKCOL {p}: {r.status}")

        _, launches["dav.mkcol"] = counted(mkcol)
        for i, size in enumerate(fs_sizes(rng, dav_bytes, 1024, max_file)):
            files.add(f"{colls[i % dav_dirs]}/f{i:04d}.bin", size)
        surfaces["webdav"] = list(files.files)

        def ops_of(paths: list, method: str) -> list:
            return [[{"method": method, "path": p, "seed": seed,
                      "nid": files.files[p][0], "size": files.files[p][1]}]
                    for p in paths]

        def acked(got: dict, groups: list, want: int, what: str) -> list:
            lat = []
            for group in groups:
                for op in group:
                    _, status, secs, equal = got[op["id"]]
                    tally.add(status)
                    if status != want or not equal:
                        raise AssertionError(
                            f"{what} {op['method']} {op['path']}: "
                            f"{status}, bytes equal {equal}")
                    lat.append(secs)
            return lat

        puts = ops_of(surfaces["webdav"], "PUT")

        def put() -> dict:
            got, wall = dav_clients(gw.url, puts)
            return {"lat": acked(got, puts, 201, "webdav"), "wall": wall}

        up, launches["dav.put"] = counted(put)
        nbytes = sum(files.files[p][1] for p in surfaces["webdav"])
        bal_log("dav.put", up["wall"], launches["dav.put"],
                files=len(puts), bytes=nbytes, collections=dav_dirs,
                gbps=nbytes / up["wall"] / 1e9,
                per_file=latency_summary(up["lat"]))
        gets = ops_of(surfaces["webdav"], "GET")

        def get() -> dict:
            got, wall = dav_clients(gw.url, gets)
            return {"lat": acked(got, gets, 200, "webdav"), "wall": wall}

        rd, launches["dav.get"] = counted(get)
        bal_log("dav.get", rd["wall"], launches["dav.get"], files=len(gets),
                gbps=nbytes / rd["wall"] / 1e9,
                per_file=latency_summary(rd["lat"]))

        movers = [str(p) for p in rng.choice(surfaces["webdav"], moves,
                                              replace=False)]

        def move_copy() -> dict:
            statuses = collections.Counter()
            for k, src in enumerate(movers):
                dst = f"{colls[(k * 7 + 3) % dav_dirs]}/mv{k:03d}.bin"
                r, _ = dav_call(gw.url, "MOVE", src, headers={
                    "Destination": f"http://{gw.url}{dst}"}, tally=tally)
                statuses[r.status] += 1
                if r.status != 201:
                    raise AssertionError(f"MOVE {src} -> {dst}: {r.status}")
                files.files[dst] = files.files.pop(src)
            # Overwrite: F onto a file that exists is refused
            one, other = sorted(files.files)[:2]
            r, _ = dav_call(gw.url, "MOVE", one, headers={
                "Destination": f"http://{gw.url}{other}",
                "Overwrite": "F"}, tally=tally)
            if r.status != 412:
                raise AssertionError(f"MOVE with Overwrite: F: {r.status}")
            src, dst = colls[0], colls[0] + "copy"
            r, secs = dav_call(gw.url, "COPY", src, headers={
                "Destination": f"http://{gw.url}{dst}/"}, tally=tally)
            if r.status != 201:
                raise AssertionError(f"COPY {src}: {r.status}")
            copied = files.under(src + "/")
            for p in copied:
                files.files[dst + p[len(src):]] = files.files[p]
            return {"moves": dict(statuses), "copied": len(copied),
                    "copy_s": secs}

        t0 = time.perf_counter()
        mc, launches["dav.move_copy"] = counted(move_copy)
        bal_log("dav.move_copy", time.perf_counter() - t0,
                launches["dav.move_copy"], **mc)

        # (18b) LOCK, a PUT without the token (423), with it (2xx), UNLOCK
        locked = [str(p) for p in rng.choice(sorted(files.files), locks,
                                              replace=False)]

        def lock_cycle() -> dict:
            seen = []
            for p in locked:
                r, _ = dav_call(gw.url, "LOCK", p, DAV_LOCKINFO,
                                {"Timeout": "Second-600"}, tally=tally)
                token = r.headers.get("Lock-Token", "").strip("<>")
                size = int(np.exp(rng.uniform(np.log(1024), np.log(MIB))))
                nid = files.next_nid
                files.next_nid += 1
                body = payload(seed, nid, size)
                r2, _ = dav_call(gw.url, "PUT", p, body, tally=tally)
                r3, _ = dav_call(gw.url, "PUT", p, body,
                                 {"If": f"(<{token}>)"}, tally=tally)
                if r3.status < 300:
                    files.files[p] = (nid, size)
                r4, _ = dav_call(gw.url, "UNLOCK", p,
                                 headers={"Lock-Token": f"<{token}>"},
                                 tally=tally)
                seen.append((r.status, r2.status, r3.status, r4.status))
            if any(s[0] != 200 or s[1] != 423 or not 200 <= s[2] < 300 or
                   s[3] != 204 for s in seen):
                raise AssertionError(f"lock answers {seen}")
            return {"files": len(seen), "answers": seen[0]}

        t0 = time.perf_counter()
        lk, launches["dav.locks"] = counted(lock_cycle)
        bal_log("dav.locks", time.perf_counter() - t0, launches["dav.locks"],
                **lk)
        surfaces["webdav"] = list(files.files)

        def propfinds() -> dict:
            lat = []
            for c in colls + [colls[0] + "copy"]:
                got, secs = dav_propfind(gw.url, c, tally)
                lat.append(secs)
                want = {c + "/": None, **{p: files.files[p][1]
                                          for p in files.under(c + "/")}}
                if got != want:
                    raise AssertionError(
                        f"PROPFIND {c}: {len(got)} entries, want "
                        f"{len(want)}: {sorted(set(got) ^ set(want))[:4]}")
            return {"lat": lat}

        t0 = time.perf_counter()
        pf, launches["dav.propfind"] = counted(propfinds)
        bal_log("dav.propfind", time.perf_counter() - t0,
                launches["dav.propfind"], collections=len(pf["lat"]),
                per_propfind=latency_summary(pf["lat"]))

        # (18c) the mount as an in-process WFS: seeded pieces, overlapping
        # and out of order; a truncate and a rename while open; xattrs
        # and hard links. A bytearray per file is the plain reference
        early: collections.Counter = collections.Counter()
        real_flush = wfs_mod.FileHandle._flush_largest_locked

        def counting_flush(fh) -> None:
            early[fh.path] += 1
            real_flush(fh)

        wfs = wfs_mod.WFS(filer.url, chunk_size=chunk, cache_ttl=0.0)
        # the generator's top size first, whose last covering piece fills
        # a chunk's worth of dirty pages and flushes it early
        sizes = [min(max_file, mount_bytes)] + fs_sizes(
            rng, mount_bytes - min(max_file, mount_bytes), 1024, max_file)
        plans = []
        nid = 1 << 20
        for i, size in enumerate(sizes):
            pieces = mount_pieces(rng, size, nid)
            nid += len(pieces)
            plans.append((f"/mnt/m{i:03d}.bin", size, pieces))
        cut, moved = plans[1][0], plans[2][0]

        def write_one(plan) -> tuple:
            path, size, pieces = plan
            t0 = time.perf_counter()
            buf = bytearray(size)
            fh = wfs.create(path)
            for off, pnid, n in pieces:
                data = payload(seed, pnid, n)
                wfs.write(fh, data, off)
                buf[off:off + n] = data
            if path == cut:
                # truncated while open: the cut bytes must not come back
                # at release, and a write across the cut lands
                keep = size // 2
                wfs.truncate(path, keep)
                del buf[keep:]
                data = payload(seed, pnid + (1 << 30), 1000)
                at = max(0, keep - 100)
                wfs.write(fh, data, at)
                buf[at:at + 1000] = data
            if path == moved:
                # renamed while open: the release saves at the new name
                path += ".renamed"
                wfs.rename(plan[0], path)
            if wfs.read(fh, len(buf), 0) != bytes(buf):
                raise AssertionError(f"mount: {path} reads back wrong "
                                     f"before its release")
            wfs.release(fh)
            return path, bytes(buf), time.perf_counter() - t0

        def mount_write() -> dict:
            wfs_mod.FileHandle._flush_largest_locked = counting_flush
            try:
                t0 = time.perf_counter()
                lat = []
                with ThreadPoolExecutor(MNT_THREADS) as ex:
                    for path, data, secs in ex.map(write_one, plans):
                        model[path] = data
                        lat.append(secs)
                write_s = time.perf_counter() - t0
            finally:
                wfs_mod.FileHandle._flush_largest_locked = real_flush
            chunks = {p: len(wfs.lookup(p)["chunks"]) for p in model}
            if wfs.lookup(moved) is not None or wfs.lookup(
                    moved + ".renamed") is None:
                raise AssertionError("the rename of an open file")
            named = sorted(model)
            tagged = named[:MNT_XATTRS]
            for p in tagged:
                wfs.setxattr(p, "user.sha256",
                             hashlib.sha256(model[p]).hexdigest().encode())
            linked = named[-MNT_LINKS:]
            for p in linked:
                wfs.link(p, p + ".lnk")
                wfs.unlink(p)
                model[p + ".lnk"] = model.pop(p)
            # a tagged file that is also linked keeps its xattr under
            # the link's name (the entry's extended map goes with it)
            tagged = [p + ".lnk" if p in linked else p for p in tagged]
            return {"write_s": write_s, "chunks": chunks, "lat": lat,
                    "tagged": tagged, "linked": linked}

        mw, launches["dav.mount_write"] = counted(mount_write)
        mbytes = sum(len(d) for d in model.values())
        bal_log("dav.mount_write", mw["write_s"], launches["dav.mount_write"],
                files=len(model), bytes=mbytes,
                pieces=sum(len(p[2]) for p in plans),
                gbps=mbytes / mw["write_s"] / 1e9,
                per_file=latency_summary(mw["lat"]),
                early_flushes=dict(early),
                flushes_per_file=sum(mw["chunks"].values()) / len(model),
                chunks_max=max(mw["chunks"].values()),
                truncated=cut, renamed=moved)
        if not early:
            raise AssertionError("no mount file flushed early")
        surfaces["mount"] = sorted(model)
        wfs.destroy()
        wfs = None

        # (18d) fsspec: fs.open(..., "wb") and pipe_file, ls, info, ranges
        fss_paths: list = []
        try:
            import fsspec

            from seaweedfs_torch.integrations.fsspec_fs import register
        except ImportError as e:
            log({"phase": "dav.fsspec", "skipped": repr(e), "card": SMI[0]})
            fsspec = None
        if fsspec is not None:
            register()
            fss = fsspec.filesystem("seaweedfs", filer=filer.url)
            for i, size in enumerate(fs_sizes(rng, fsspec_bytes, 1024,
                                              max_file)):
                fss_paths.append(f"/fss/f{i:03d}.bin")
                files.add(fss_paths[-1], size)

            def fsspec_write() -> dict:
                lat = []
                for i, p in enumerate(fss_paths):
                    data = files.data(p)
                    t0 = time.perf_counter()
                    if i % 2 == 0:
                        with fsspec.open(f"seaweedfs://{filer.url}{p}",
                                         "wb") as f:
                            f.write(data)
                    else:
                        fss.pipe_file(p, data)
                    lat.append(time.perf_counter() - t0)
                names = sorted(fss.ls("/fss", detail=False))
                if names != sorted(p[1:] for p in fss_paths):
                    raise AssertionError(f"fsspec ls: {names}")
                for p in fss_paths:
                    info = fss.info(p)
                    if info["type"] != "file" or \
                            info["size"] != files.files[p][1]:
                        raise AssertionError(f"fsspec info {p}: {info}")
                return {"lat": lat, "secs": sum(lat)}

            fw, launches["dav.fsspec_write"] = counted(fsspec_write)
            fbytes = sum(files.files[p][1] for p in fss_paths)
            bal_log("dav.fsspec_write", fw["secs"],
                    launches["dav.fsspec_write"], files=len(fss_paths),
                    bytes=fbytes, gbps=fbytes / fw["secs"] / 1e9,
                    per_file=latency_summary(fw["lat"]))
        surfaces["fsspec"] = fss_paths

        def fsspec_read() -> dict:
            lat = []
            for p in fss_paths:
                want = files.data(p)
                t0 = time.perf_counter()
                got = fss.cat_file(p)
                lat.append(time.perf_counter() - t0)
                if hashlib.sha256(got).digest() != hashlib.sha256(
                        want).digest():
                    raise AssertionError(f"fsspec cat_file {p}")
                for s, e in fs_ranges(np.random.default_rng(
                        (seed, files.files[p][0])), len(want), chunk):
                    if fss.cat_file(p, start=s, end=e + 1) != want[s:e + 1]:
                        raise AssertionError(f"fsspec {p} [{s}, {e}]")
            return {"lat": lat, "secs": sum(lat)}

        # (18e) JSON documents through the client, queried on the volume
        # servers; the answers are known by construction
        client = Client(master)
        doc_rows = []
        for i in range(docs):
            n, b = int(rng.integers(1000)), int(rng.integers(10))
            tag = "".join(rng.choice(list("abcdwxyz"), 6))
            doc = {"id": i, "n": n, "a": {"b": b}, "tag": tag, "pad": ""}
            size = int(np.exp(rng.uniform(np.log(QRY_DOC[0]),
                                          np.log(QRY_DOC[1]))))
            doc["pad"] = "p" * max(0, size - len(json.dumps(doc)))
            doc_rows.append(doc)

        # fids from the threaded bulk-assign lease pool over the client's
        # /dir/assign?count=N, as the reference's client takes them
        refills: list = []

        def refill(params: dict, count: int) -> dict:
            refills.append(count)
            return client.assign(count=count, **params)

        lease = AssignLeasePool(refill)

        def doc_upload() -> list:
            def one(d: dict) -> str:
                a = lease.get(collection=QRY_COLLECTION)
                client.upload_blob(a["url"], a["fid"],
                                   json.dumps(d).encode())
                return a["fid"]

            with ThreadPoolExecutor(QRY_THREADS) as ex:
                return list(ex.map(one, doc_rows))

        t0 = time.perf_counter()
        doc_fids, launches["dav.query_upload"] = counted(doc_upload)
        bal_log("dav.query_upload", time.perf_counter() - t0,
                launches["dav.query_upload"], documents=len(doc_fids),
                bytes=sum(len(json.dumps(d)) for d in doc_rows),
                master_assigns=len(refills), keys_leased=sum(refills))
        expected = []
        for flt, proj in DAV_QUERIES:
            ok = {"<": lambda x, y: x < y, "=": lambda x, y: x == y,
                  "contains": lambda x, y: y in x}[flt["op"]]
            rows = []
            for d in doc_rows:
                got = d["a"]["b"] if flt["field"] == "a.b" else d[flt["field"]]
                if ok(got, flt["value"]):
                    rows.append({p.split(".")[-1]: (d["a"]["b"] if p == "a.b"
                                                    else d[p]) for p in proj})
            expected.append(rows)

        def queries(c) -> dict:
            lat, answers = [], []
            for (flt, proj), want in zip(DAV_QUERIES, expected):
                t0 = time.perf_counter()
                got = c.query(doc_fids, flt, proj)
                lat.append(time.perf_counter() - t0)
                if sorted(got, key=lambda r: r["id"]) != want:
                    raise AssertionError(
                        f"query {flt}: {len(got)} answers, want "
                        f"{len(want)}")
                answers.append(len(got))
            return {"lat": lat, "answers": answers}

        qh, launches["dav.query"] = counted(lambda: queries(client))
        bal_log("dav.query", sum(qh["lat"]), launches["dav.query"],
                answers=qh["answers"], per_call=latency_summary(qh["lat"]))

        # (18f) the CLI mount on a kernel mount point, where the host
        # serves one: files copied in with plain open()
        kernel_files: list = []
        why = fuse_probe(work) if kernel_mount else "not asked for"
        if why:
            log({"phase": "dav.kernel_mount", "skipped": why,
                 "card": SMI[0]})
        else:
            kmnt.mkdir()
            t0 = time.perf_counter()
            kproc = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_torch.cli", "mount",
                 "-filer", filer.url, "-dir", str(kmnt), "-chunk_size_mb",
                 cli_chunk_mb(chunk)], cwd=str(REPO),
                stdout=subprocess.DEVNULL,
                stderr=open(work / "mount.log", "ab"))
            if not fuse_wait(kproc, kmnt, 60.0):
                raise AssertionError("the CLI mount never appeared")
            (kmnt / "kdir").mkdir()
            for i in range(KMNT_FILES):
                size = int(np.exp(rng.uniform(np.log(64 * 1024),
                                              np.log(2 * MIB))))
                p = f"/kdir/k{i}.bin"
                data = files.add(p, size)
                with open(kmnt / p[1:], "wb") as f:
                    f.write(data)
                if (kmnt / p[1:]).read_bytes() != data:
                    raise AssertionError(f"kernel mount: {p} reads back "
                                         f"wrong")
                kernel_files.append(p)
            log({"phase": "dav.kernel_mount", "seconds":
                 time.perf_counter() - t0, "files": kernel_files,
                 "card": SMI[0]})
        surfaces["kernel"] = kernel_files

        # (18g) the warm-down: every volume holding a file of the phase,
        # EC-encoded with the shell's ec.encode on the card
        fids_of = dav_fids(filer.url, surfaces["webdav"] + surfaces["mount"]
                           + surfaces["fsspec"] + surfaces["kernel"])
        fids_of.update({f"/docs/{i}": [f] for i, f in enumerate(doc_fids)})
        vols = sorted({(int(f.split(",")[0]),
                        QRY_COLLECTION if p.startswith("/docs/") else "")
                       for p, fl in fids_of.items() for f in fl})
        shell_commands._register_all()
        env = shell_commands.CommandEnv(Client(master))

        def ec_encode() -> None:
            for vid, coll in vols:
                shell_commands.run_command(
                    env, ["ec.encode", "-volumeId", str(vid),
                          "-collection", coll])
            for vid, _ in vols:
                shards = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                if len(shards.get("shards", {})) != 14 or any(
                        cl.store(i).find_volume(vid) is not None
                        for i in range(len(cl.nodes))):
                    raise AssertionError(f"ec.encode {vid}: {shards}")

        t0 = time.perf_counter()
        _, launches["dav.ec_encode"] = counted(ec_encode)
        bal_log("dav.ec_encode", time.perf_counter() - t0,
                launches["dav.ec_encode"], volumes=[v for v, _ in vols])

        # which surfaces have a needle on a shard about to be lost: their
        # reads must reach the card
        def on_victims(paths: list) -> int:
            count = 0
            for vid, _ in vols:
                ev = next(ev for ev in (cl.store(i).find_ec_volume(vid)
                                        for i in range(len(cl.nodes)))
                          if ev is not None)
                mine = [f for p in paths for f in fids_of[p]
                        if int(f.split(",")[0]) == vid]
                count += needles_on_shards(ev, mine, set(), VICTIMS)
            return count

        victims = {"webdav": on_victims(surfaces["webdav"]),
                   "mount": on_victims(surfaces["mount"]),
                   "fsspec": on_victims(surfaces["fsspec"]),
                   "kernel": on_victims(surfaces["kernel"]),
                   "query": on_victims([p for p in fids_of
                                        if p.startswith("/docs/")])}
        dropped: list = []

        def drop() -> None:
            for vid, coll in vols:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": coll,
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
                    dropped.append((vid, sid, url))
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v, _ in vols),
                "the lookup drops the four shards")

        _, launches["dav.drop_shards"] = counted(drop)

        # (18h) every file read back with 4 shards lost, through each
        # surface; the mount through a fresh WFS (an empty chunk cache)
        dgets = ops_of(surfaces["webdav"], "GET")

        def read_webdav() -> dict:
            got, wall = dav_clients(gw.url, dgets)
            return {"lat": acked(got, dgets, 200, "degraded"),
                    "wall": wall}

        rw, launches["dav.read_webdav"] = counted(read_webdav)
        wbytes = sum(files.files[p][1] for p in surfaces["webdav"])
        bal_log("dav.read_webdav", rw["wall"], launches["dav.read_webdav"],
                lost_shards=list(VICTIMS), files=len(dgets), bytes=wbytes,
                gbps=wbytes / rw["wall"] / 1e9,
                needles_on_victims=victims["webdav"],
                per_file=latency_summary(rw["lat"]))

        def read_mount() -> dict:
            fresh = wfs_mod.WFS(filer.url, chunk_size=chunk, cache_ttl=0.0)
            try:
                lat = []
                for p in surfaces["mount"]:
                    t0 = time.perf_counter()
                    fh = fresh.open(p)
                    got = fresh.read(fh, len(model[p]) + 1, 0)
                    fresh.release(fh)
                    lat.append(time.perf_counter() - t0)
                    if got != model[p] or \
                            fresh.getattr(p)["size"] != len(model[p]):
                        raise AssertionError(f"mount: {p}, {len(got)} of "
                                             f"{len(model[p])} bytes")
                for p in mw["tagged"]:
                    want = hashlib.sha256(model[p]).hexdigest().encode()
                    if fresh.getxattr(p, "user.sha256") != want or \
                            fresh.listxattr(p) != ["user.sha256"]:
                        raise AssertionError(f"mount: xattr of {p}")
                for p in mw["linked"]:
                    if fresh.lookup(p) is not None or not fresh.lookup(
                            p + ".lnk").get("hard_link_id"):
                        raise AssertionError(f"mount: hard link of {p}")
                hits = fresh.client.chunk_cache.stats()["hits"]
                return {"lat": lat, "cache_hits": hits}
            finally:
                fresh.destroy()

        t0 = time.perf_counter()
        rm, launches["dav.read_mount"] = counted(read_mount)
        mnt_s = time.perf_counter() - t0
        bal_log("dav.read_mount", mnt_s, launches["dav.read_mount"],
                files=len(surfaces["mount"]), bytes=mbytes,
                gbps=mbytes / mnt_s / 1e9, chunk_cache_hits=rm["cache_hits"],
                needles_on_victims=victims["mount"],
                per_file=latency_summary(rm["lat"]))
        if fss is not None:
            rf, launches["dav.read_fsspec"] = counted(fsspec_read)
            bal_log("dav.read_fsspec", rf["secs"],
                    launches["dav.read_fsspec"], files=len(fss_paths),
                    gbps=fbytes / rf["secs"] / 1e9,
                    needles_on_victims=victims["fsspec"],
                    per_file=latency_summary(rf["lat"]))
        if kernel_files:
            def read_kernel() -> None:
                for p in kernel_files:
                    if hashlib.sha256((kmnt / p[1:]).read_bytes()).digest() \
                            != hashlib.sha256(files.data(p)).digest():
                        raise AssertionError(f"kernel mount: {p} after the "
                                             f"encode")

            t0 = time.perf_counter()
            _, launches["dav.read_kernel"] = counted(read_kernel)
            bal_log("dav.read_kernel", time.perf_counter() - t0,
                    launches["dav.read_kernel"], files=len(kernel_files),
                    needles_on_victims=victims["kernel"])
        qd, launches["dav.query_degraded"] = counted(
            lambda: queries(Client(master)))
        bal_log("dav.query_degraded", sum(qd["lat"]),
                launches["dav.query_degraded"], answers=qd["answers"],
                needles_on_victims=victims["query"],
                per_call=latency_summary(qd["lat"]))
    finally:
        if wfs is not None:
            wfs.destroy()
        if kproc is not None:
            fuse_unmount(kproc, kmnt)
        gw.stop()
        filer.stop()
        cl.shutdown()
    if coder_name == "auto":
        surface_of = {"dav.read_webdav": "webdav", "dav.read_mount": "mount",
                      "dav.read_fsspec": "fsspec", "dav.read_kernel": "kernel",
                      "dav.query_degraded": "query"}
        for step, counts in launches.items():
            others = {k: n for k, n in counts.items()
                      if k != "gf_apply" and n}
            want = step in DAV_CODER_STEPS and (
                step not in surface_of or victims[surface_of[step]] > 0)
            if others or want != (counts["gf_apply"] > 0):
                raise AssertionError(f"{step}: launches {counts}")
        for step in ("dav.ec_encode", "dav.read_mount", "dav.query_degraded"):
            if launches[step]["gf_apply"] == 0:
                raise AssertionError(f"{step} never reached the card")
    bal_log("dav.summary", time.perf_counter() - t_phase, launches,
            answers=dict(tally.statuses), victims=victims,
            files_lost=0,
            gf_apply_per_step={k: v["gf_apply"] for k, v in launches.items()})
    shutil.rmtree(work, ignore_errors=True)
    return launches


# --- phase 19: the cross-cluster planes ------------------------------------

GEO_LIMIT_MB = 64
GEO_CHUNK = 8 * MIB              # the CLI filers' chunks
GEO_MAX_FILE = 8 * MIB           # phase 3's generator: log-uniform 1 KiB ..
GEO_BYTES = 32 * MIB             # ... into the versioned bucket, half
                                 # before its replication rule
GEO_CLIENTS = 4                  # S3 clients (2 processes)
GEO_OVERWRITES = 6               # the tail: live/ objects overwritten,
GEO_DELETES = 4                  # gone/ objects deleted (delete markers)
GEO_TAIL_NEW = 4                 # and new objects, the replica filer
                                 # killed and restarted among them
GEO_STEADY = 100                 # the tail's steady segment: new objects
#                                  (200 before phase 20)
GEO_STEADY_MAX = 4096            # of 1 KiB .. this, both filers up, in
GEO_STEADY_DIRS = 8              # this many prefixes (the appliers keep
                                 # each directory's events in order)
GEO_AA_OBJECTS = 4               # each side's writes, active-active bucket
GEO_READERS = 8                  # failover reads in flight


def geo_bucket_entry(bucket: str, rule: dict = None) -> dict:
    """A bucket's filer entry, with a replication rule (geo.rules' JSON)
    when given: the form PutBucketReplication stores."""
    from seaweedfs_torch.geo import rules as geo_rules
    ext = ({geo_rules.BUCKET_ATTR: geo_rules.rules_to_json([rule])}
           if rule else {})
    return {"path": f"/buckets/{bucket}",
            "attr": {"mode": 0o40770, "mtime": time.time(),
                     "crtime": time.time()},
            "chunks": [], "extended": ext}


def geo_namespace(filer: str, root: str, tally) -> dict:
    """path -> (is dir, version id, delete marker, sha256 of the bytes)
    of everything under `root`, every file read through `filer`."""
    from seaweedfs_torch.geo import versioning as geo_ver
    out = {}
    for path, e in fs_walk(filer, root).items():
        is_dir = bool(e["attr"]["mode"] & 0o40000)
        ext = e.get("extended") or {}
        sha = ""
        if not is_dir:
            r = http.request("GET", f"http://{filer}{path}", timeout=600)
            tally.add(r.status)
            if r.status != 200:
                raise AssertionError(f"GET {filer}{path}: {r.status}")
            sha = hashlib.sha256(r.data).hexdigest()
        out[path] = (is_dir, ext.get(geo_ver.VERSION_ID_ATTR, ""),
                     geo_ver.DELETE_MARKER_ATTR in ext, sha)
    return out


def run_geo(work: Path, seed: int = SEED + 19, coder_name: str = "auto",
            device=None, limit_mb: int = GEO_LIMIT_MB,
            total: int = GEO_BYTES, max_file: int = GEO_MAX_FILE,
            chunk: int = GEO_CHUNK, overwrites: int = GEO_OVERWRITES,
            deletes: int = GEO_DELETES, tail_new: int = GEO_TAIL_NEW,
            aa_objects: int = GEO_AA_OBJECTS) -> dict:
    """Phase 19; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in both encodes, in the backfill and in
    both failover reads where a replicated needle lies on a lost shard,
    more than 0 in the phase; no other kernel); ``coder_name="torch",
    device="cpu"`` at a few MB runs it on a host without one (no launch
    is counted there; `chunk` whole MiB, as the CLI filer takes it)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.balance import BalanceConfig
    from seaweedfs_torch.geo import GeoConfig
    from seaweedfs_torch.geo import cluster_sink as geo_sink
    from seaweedfs_torch.geo import versioning as geo_ver
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    launches: dict = {}
    tally = S3Tally()
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    p_filer = f"127.0.0.1:{free_port()}"
    r_filer = f"127.0.0.1:{free_port()}"

    def cluster(name: str, filer: str) -> LocalCluster:
        # each master's geo daemon scans its own filer; passes run on
        # /geo/run (the interval is out of the phase's reach)
        return LocalCluster(
            2, coder_name=coder_name, device=device,
            volume_size_limit_mb=limit_mb, pulse=0.5,
            directory=str(work / name), racks=2,
            master_kwargs={"repair_enabled": False,
                           "balance_config": BalanceConfig(
                               force_enabled=False),
                           "geo_config": GeoConfig(
                               filer=filer, interval=3600.0, appliers=4)})

    # every successful apply of the geo jobs, by (source, replica, tsns),
    # and the applies of an event the replica had already signed
    applies: collections.Counter = collections.Counter()
    looped: list = []
    sigs: dict = {}
    orig_apply = geo_sink.ClusterSink.apply

    async def recording_apply(self, event):
        await orig_apply(self, event)
        applies[(self.source, self.remote, event.tsns)] += 1
        if sigs.get(self.remote) in event.signatures:
            looped.append((self.source, event.tsns))

    geo_sink.ClusterSink.apply = recording_apply
    cl_p = cl_r = drain = None
    procs: list = []
    try:
        cl_p = cluster("primary", p_filer)
        cl_r = cluster("replica", r_filer)
        p_master, r_master = cl_p.master_url, cl_r.master_url
        spool = work / "spool"
        pcwd = work / "primary_cwd"
        pcwd.mkdir()
        (pcwd / "notification.toml").write_text(
            f'[notification.file]\nenabled = true\n'
            f'directory = "{spool}"\n')
        config = work / "s3.json"
        config.write_text(json.dumps({"identities": S3P_IDENTITIES}))

        def filer_proc(url: str, name: str, cwd=None) -> CliFiler:
            return CliFiler(work, [
                "filer", "-mserver", p_master if url == p_filer
                else r_master, "-store", "leveldb2", "-store_path",
                str(work / f"{name}_leveldb2"), "-chunk_size_mb",
                cli_chunk_mb(chunk)], name=name,
                port=int(url.rsplit(":", 1)[1]), cwd=cwd)

        pf = filer_proc(p_filer, "pfiler", cwd=pcwd)
        rf = filer_proc(r_filer, "rfiler")
        gw = CliFiler(work, ["s3", "-filer", p_filer, "-config",
                             str(config)], name="s3",
                      env={"WEED_GEO_REPLICA_FILER": r_filer})
        procs = [pf, rf, gw]
        for proc in procs:
            proc.start()
        for proc in procs:
            wait_until(proc.up, f"the CLI {proc.name}", timeout=120)
        for url in (p_filer, r_filer):
            sigs[url] = fs_meta(url, "info")["signature"]
        log({"phase": "geo.setup", "seconds": time.perf_counter() - t_phase,
             "primary_filer": p_filer, "replica_filer": r_filer,
             "gateway": gw.url, "card": SMI[0]})

        # (19a) the versioned bucket on the primary (through the gateway)
        # and on the replica (its entry: bucket entries do not replicate)
        for path, body in (("/geo", b""), ("/geo?versioning",
                           b"<VersioningConfiguration><Status>Enabled"
                           b"</Status></VersioningConfiguration>")):
            r, _ = s3_call(gw.url, "PUT", path, body, tally=tally)
            if r.status != 200:
                raise AssertionError(f"PUT {path}: {r.status}")
        status, out = http.post_json(f"http://{r_filer}/__meta__/"
                                     "create_entry",
                                     {"entry": geo_bucket_entry("geo")})
        if status != 200:
            raise AssertionError(f"replica bucket: {status} {out}")
        sizes = fs_sizes(rng, total, 1024, max_file)
        half = len(sizes) // 2
        if half < 2 * deletes or len(sizes) - half < overwrites:
            raise AssertionError(f"{len(sizes)} objects: too few")
        for i, size in enumerate(sizes):
            gone = i < 2 * deletes and i % 2
            files.add(f"{'gone' if gone else 'live'}/o{i:04d}.bin", size)
        keys = list(files.files)
        # version id -> (key, nid, size) of every acknowledged PUT
        acked: dict = {}

        def put_all(batch: list) -> dict:
            groups = [[{"method": "PUT", "path": f"/geo/{k}", "seed": seed,
                        "nid": files.files[k][0],
                        "size": files.files[k][1]}] for k in batch]
            got, wall = s3_clients(gw.url, groups, clients=GEO_CLIENTS)
            for group in groups:
                op = group[0]
                _, status, secs, vid, _ = got[op["id"]]
                tally.add(status)
                if status != 200 or not vid:
                    raise AssertionError(f"PUT {op['path']}: {status}")
                acked[vid] = (op["path"][len("/geo/"):], op["nid"],
                              op["size"])
            return {"wall": wall, "objects": len(batch), "bytes": sum(
                files.files[k][1] for k in batch)}

        pre, launches["geo.put_pre_rule"] = counted(
            lambda: put_all(keys[:half]))
        bal_log("geo.put_pre_rule", pre["wall"],
                launches["geo.put_pre_rule"], **pre,
                gbps=pre["bytes"] / pre["wall"] / 1e9)
        rule = (b"<ReplicationConfiguration><Rule><Status>Enabled</Status>"
                b"<Destination><Bucket>arn:aws:s3:::geo</Bucket><Endpoint>"
                + r_filer.encode() + b"</Endpoint></Destination></Rule>"
                b"</ReplicationConfiguration>")
        r, _ = s3_call(gw.url, "PUT", "/geo?replication", rule, tally=tally)
        if r.status != 200:
            raise AssertionError(f"PutBucketReplication: {r.status}")
        post, launches["geo.put_post_rule"] = counted(
            lambda: put_all(keys[half:]))
        bal_log("geo.put_post_rule", post["wall"],
                launches["geo.put_post_rule"], **post,
                gbps=post["bytes"] / post["wall"] / 1e9)

        # (19b) the primary's volumes encoded by the shell, 4 shards lost
        shell_commands._register_all()

        def encode(master: str, cl, filer: str) -> tuple:
            fids = dav_fids(filer, [p for p, v in fs_walk(
                filer, "/buckets/geo").items()
                if not v["attr"]["mode"] & 0o40000])
            vids = sorted({int(f.split(",")[0]) for fl in fids.values()
                           for f in fl})
            env = shell_commands.CommandEnv(Client(master))
            for vid in vids:
                shell_commands.run_command(
                    env, ["ec.encode", "-volumeId", str(vid),
                          "-collection", ""])
            for vid in vids:
                shards = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                if len(shards.get("shards", {})) != 14:
                    raise AssertionError(f"ec.encode {vid}: {shards}")
            return vids, fids

        def drop(master: str, vids: list) -> None:
            for vid in vids:
                info = http.get_json(
                    f"http://{master}/col/lookup/ec?volumeId={vid}")[1]
                for sid in VICTIMS:
                    url = info["shards"][str(sid)][0]
                    status, out = http.post_json(
                        f"http://{url}/admin/ec/delete_shards",
                        {"volume_id": vid, "collection": "",
                         "shard_ids": [sid]})
                    if status != 200:
                        raise AssertionError(f"drop {vid}.{sid}: {out}")
            wait_until(lambda: all(len(http.get_json(
                f"http://{master}/col/lookup/ec?volumeId={v}")[1][
                    "shards"]) == 14 - len(VICTIMS) for v in vids),
                "the lookup drops the four shards")

        def on_victims(cl, vids: list, fids: dict) -> int:
            count = 0
            for vid in vids:
                ev = next(ev for ev in (cl.store(i).find_ec_volume(vid)
                                        for i in range(len(cl.nodes)))
                          if ev is not None)
                mine = [f for fl in fids.values() for f in fl
                        if int(f.split(",")[0]) == vid]
                count += needles_on_shards(ev, mine, set(), VICTIMS)
            return count

        t0 = time.perf_counter()
        (p_vids, p_fids), launches["geo.ec_encode_primary"] = counted(
            lambda: encode(p_master, cl_p, p_filer))
        bal_log("geo.ec_encode_primary", time.perf_counter() - t0,
                launches["geo.ec_encode_primary"], volumes=p_vids)
        _, launches["geo.drop_shards_primary"] = counted(
            lambda: drop(p_master, p_vids))
        p_victims = on_victims(cl_p, p_vids, p_fids)

        # (19c) /geo/run: the job backfills the bucket (every source read
        # with 4 shards lost), then tails; passes until the lag is 0
        def job(cl, bucket: str):
            return cl.master.geo.jobs.get(bucket)

        def geo_run(master: str) -> dict:
            status, out = http.post_json(f"http://{master}/geo/run", {})
            if status != 200 or not out.get("ok"):
                raise AssertionError(f"/geo/run: {status} {out}")
            return out

        def caught_up(cl, bucket: str) -> bool:
            geo_run(cl.master_url)
            j = job(cl, bucket)
            return (j is not None and j.state == "streaming"
                    and j.current_lag_s() == 0.0)

        def backfill() -> dict:
            t0 = time.perf_counter()
            out = geo_run(p_master)
            if "geo" not in out["started"]:
                raise AssertionError(f"/geo/run started {out}")
            wait_until(lambda: caught_up(cl_p, "geo"), "the backfill",
                       timeout=300)
            secs = time.perf_counter() - t0
            src = geo_namespace(p_filer, "/buckets/geo", tally)
            dst = geo_namespace(r_filer, "/buckets/geo", tally)
            if src != dst:
                diff = sorted(set(src.items()) ^ set(dst.items()))[:4]
                raise AssertionError(f"after the backfill: {diff}")
            return {"secs": secs, "entries": len(src),
                    "backfilled": job(cl_p, "geo").backfilled}

        bf, launches["geo.backfill"] = counted(backfill)
        bal_log("geo.backfill", bf["secs"], launches["geo.backfill"],
                entries=bf["entries"], backfilled=bf["backfilled"],
                on_lost_shards=p_victims)

        # (19d) the tail. First a steady segment: small new objects by 4
        # clients with both filers up, whose lag (each PUT's answer to
        # its version on the replica) and events/s are the replication
        # metrics. Then the drill: overwrites, new objects and versioned
        # deletes by 4 clients, the replica filer killed (SIGKILL) once
        # a third of them have replicated and restarted after two thirds
        live = [k for k in keys if k.startswith("live/")]
        steady_ops = [("PUT", f"steady/d{i % GEO_STEADY_DIRS}/s{i:04d}.bin",
                       files.next_nid + i,
                       int(rng.integers(1024, GEO_STEADY_MAX + 1)))
                      for i in range(GEO_STEADY)]
        files.next_nid += GEO_STEADY
        puts = live[:overwrites] + [f"live/t{i:04d}.bin"
                                    for i in range(tail_new)]
        # (method, key, nid, size): each PUT a new body of its own
        ops = [("PUT", k, files.next_nid + i, int(np.exp(rng.uniform(
            np.log(1024), np.log(max_file))))) for i, k in enumerate(puts)]
        files.next_nid += len(puts)
        ops += [("DELETE", k, 0, 0) for k in keys if k.startswith("gone/")]
        ops = [ops[int(i)] for i in rng.permutation(len(ops))]
        visible: dict = {}
        pending: dict = {}
        lock = threading.Lock()
        done = threading.Event()

        def versions_on_replica(d: str) -> dict:
            """path -> version id of the replica's entries in `d`."""
            out, start = {}, ""
            while True:
                entries = fs_meta(r_filer, "list", dir=d, start=start,
                                  limit=1024)["entries"]
                for e in entries:
                    out[e["path"]] = (e.get("extended") or {}).get(
                        geo_ver.VERSION_ID_ATTR)
                if len(entries) < 1024:
                    return out
                start = entries[-1]["path"].rsplit("/", 1)[-1]

        def poll_replica() -> None:
            # one listing a directory a round, however many are pending
            while not done.is_set():
                with lock:
                    todo = list(pending.items())
                dirs = {f"/buckets/geo/{key}".rsplit("/", 1)[0]
                        for _, (key, _) in todo}
                seen: dict = {}
                try:
                    for d in dirs:
                        seen.update(versions_on_replica(d))
                except (OSError, AssertionError):  # the replica is down
                    pass
                now = time.perf_counter()
                with lock:
                    for vid, (key, t_ack) in todo:
                        if seen.get(f"/buckets/geo/{key}") == vid:
                            pending.pop(vid, None)
                            visible[vid] = now - t_ack
                time.sleep(0.02)

        def one(op) -> None:
            method, key, nid, size = op
            body = payload(seed, nid, size) if method == "PUT" else b""
            r, _ = s3_call(gw.url, method, f"/geo/{key}", body, tally=tally)
            t_ack = time.perf_counter()
            vid = r.headers.get("x-amz-version-id", "")
            if r.status not in (200, 204) or not vid:
                raise AssertionError(f"{method} /geo/{key}: {r.status}")
            if method == "PUT":
                with lock:
                    acked[vid] = (key, nid, size)
                    pending[vid] = (key, t_ack)

        def tail() -> dict:
            j = job(cl_p, "geo")
            before = j.status()["applied"]
            poller = threading.Thread(target=poll_replica, daemon=True)
            poller.start()
            third = max(1, len(ops) // 3)
            t0 = time.perf_counter()
            try:
                with ThreadPoolExecutor(GEO_CLIENTS) as ex:
                    list(ex.map(one, steady_ops))
                    steady_put_s = time.perf_counter() - t0
                    # every event committed, so the drill's restart
                    # starts from a caught-up offset
                    wait_until(lambda: not pending and caught_up(
                        cl_p, "geo"), "the steady segment", timeout=120)
                    steady_s = time.perf_counter() - t0
                    steady_events = j.status()["applied"] - before
                    t1 = time.perf_counter()
                    # as the reference's drill: the first third
                    # replicated, then the kill, more writes into the
                    # outage, the restart (an apply in flight at the kill
                    # would be replayed after it: at least once)
                    list(ex.map(one, ops[:third]))
                    wait_until(lambda: not pending and caught_up(
                        cl_p, "geo"), "the drill's first third",
                        timeout=120)
                    rf.kill()
                    killed = time.perf_counter()
                    list(ex.map(one, ops[third:2 * third]))
                    rf.start()
                    wait_until(rf.up, "the replica filer's restart", 120)
                    down = time.perf_counter() - killed
                    list(ex.map(one, ops[2 * third:]))
                wait_until(lambda: caught_up(cl_p, "geo") and not pending,
                           "the tail", timeout=300)
            finally:
                done.set()
                poller.join(30)
            drill_s = time.perf_counter() - t1
            src = geo_namespace(p_filer, "/buckets/geo", tally)
            dst = geo_namespace(r_filer, "/buckets/geo", tally)
            if src != dst:
                diff = sorted(set(src.items()) ^ set(dst.items()))[:4]
                raise AssertionError(f"after the tail: {diff}")
            st = j.status()
            return {"secs": time.perf_counter() - t0, "steady_s": steady_s,
                    "steady_puts": len(steady_ops),
                    "steady_put_s": steady_put_s,
                    "steady_events": steady_events, "drill_s": drill_s,
                    "replica_down_s": down, "drill_ops": len(ops),
                    "events": st["applied"] - before,
                    "restarts": st["restarts"], "poisoned": st["poisoned"],
                    "namespace": src}

        tl, launches["geo.tail"] = counted(tail)
        namespace = tl.pop("namespace")
        tail_s = tl.pop("secs")
        steady_lag = [t for v, t in visible.items()
                      if acked[v][0].startswith("steady/")]
        drill_lag = [t for v, t in visible.items()
                     if not acked[v][0].startswith("steady/")]
        events_per_s = tl["steady_events"] / tl["steady_s"]
        bal_log("geo.tail", tail_s, launches["geo.tail"], **tl,
                events_per_s=events_per_s,
                lag=latency_summary(steady_lag),
                drill_lag=latency_summary(drill_lag))
        if tl["poisoned"]:
            raise AssertionError(f"the tail poisoned {tl['poisoned']}")

        # (19f) filer.replicate -from_queue: the primary filer's
        # notification spool of the whole bucket into a LocalSink
        # directory. It runs for ever, as upstream's does: started here,
        # beside 19e, and stopped once its tree equals the primary's
        # files of the bucket, compared file by file
        rcwd = work / "replicate_cwd"
        rcwd.mkdir()
        sink_dir = work / "local_sink"
        (rcwd / "replication.toml").write_text(
            f'[source.file]\nenabled = true\ndirectory = "{spool}"\n'
            f'position_path = "{work / "spool.pos"}"\n'
            f'[sink.local]\nenabled = true\n'
            f'directory = "{sink_dir}"\n')
        drain_log = work / "filer_replicate.log"
        t_drain = time.perf_counter()
        with open(drain_log, "ab") as err:
            drain = subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_torch.cli",
                 "filer.replicate", "-filer", p_filer, "-pathPrefix",
                 "/buckets/geo/", "-offsetFile",
                 str(work / "replicate.offset"), "-from_queue"],
                cwd=str(rcwd), env=cli_env(), stdout=subprocess.DEVNULL,
                stderr=err)

        # (19e) active/active: a second bucket with a rule each way; both
        # sides converge and the jobs stop moving
        def active_active() -> dict:
            for url, other, rid in ((p_filer, r_filer, "a2b"),
                                    (r_filer, p_filer, "b2a")):
                status, out = http.post_json(
                    f"http://{url}/__meta__/create_entry",
                    {"entry": geo_bucket_entry("aa", {
                        "id": rid, "status": "Enabled", "prefix": "",
                        "dest_bucket": "aa", "endpoint": other})})
                if status != 200:
                    raise AssertionError(f"aa bucket on {url}: {out}")
            geo_run(p_master)
            geo_run(r_master)
            t0 = time.perf_counter()
            want = {}
            for i in range(aa_objects):
                for url, side in ((p_filer, "a"), (r_filer, "b")):
                    path = f"/buckets/aa/{side}{i}.bin"
                    want[path] = payload(seed + 1, i, 1024 * (i + 1))
                    status, _, _ = fs_put(url, path, want[path])
                    if status not in (200, 201):
                        raise AssertionError(f"PUT {url}{path}: {status}")

            wait_until(lambda: all(
                fs_meta_status(url, path) == 200 for url in (p_filer, r_filer)
                for path in want), "active/active convergence",
                timeout=120)
            for url in (p_filer, r_filer):
                for path, data in want.items():
                    r = http.request("GET", f"http://{url}{path}",
                                     timeout=60)
                    if r.data != data:
                        raise AssertionError(f"{url}{path} differs")
            secs = time.perf_counter() - t0
            jobs = (job(cl_p, "aa"), job(cl_r, "aa"))
            counts = [j.status()["applied"] for j in jobs]
            time.sleep(2.0)
            after = [j.status()["applied"] for j in jobs]
            if after != counts:
                raise AssertionError(f"active/active still moving: "
                                     f"{counts} -> {after}")
            return {"secs": secs, "objects": len(want), "applied": after}

        aa, launches["geo.active_active"] = counted(active_active)
        bal_log("geo.active_active", aa.pop("secs"),
                launches["geo.active_active"], **aa)

        hashed: dict = {}

        def sink_tree() -> dict:
            got = {}
            for dirpath, _, names in os.walk(sink_dir):
                for name in names:
                    full = os.path.join(dirpath, name)
                    st = os.stat(full)
                    key = (full, st.st_size, st.st_mtime_ns)
                    if key not in hashed:
                        hashed[key] = sha256_file(full)
                    got["/" + os.path.relpath(full, sink_dir)] = hashed[key]
            return got

        def filer_replicate() -> dict:
            want = {p: sha for p, (is_dir, _, _, sha) in namespace.items()
                    if not is_dir}
            wait_until(lambda: drain.poll() is None and sink_tree() == want,
                       "the queue drain", timeout=120)
            secs = time.perf_counter() - t_drain
            drain.terminate()
            drain.wait(timeout=20)
            got = sink_tree()
            if got != want:
                diff = sorted(set(got.items()) ^ set(want.items()))[:4]
                raise AssertionError(f"the local sink differs: {diff}")
            # the events it consumed: the spool's lines up to its position
            with open(work / "spool.pos", encoding="utf-8") as f:
                pos = json.load(f)
            consumed = 0
            for name in sorted(os.listdir(spool)):
                if name.endswith(".ndjson") and name <= pos["file"]:
                    with open(spool / name, "rb") as f:
                        body = f.read()
                    if name == pos["file"]:
                        body = body[:pos["offset"]]
                    consumed += body.count(b"\n")
            skipped = drain_log.read_text().count("SKIPPING")
            return {"secs": secs, "events": consumed, "skipped": skipped,
                    "files": len(got)}

        fr, launches["geo.filer_replicate"] = counted(filer_replicate)
        bal_log("geo.filer_replicate", fr.pop("secs"),
                launches["geo.filer_replicate"], **fr)

        # (19g) the replica's volumes encoded, the same 4 shards lost;
        # the primary's master and filer stopped; every object and every
        # version read back through Client(replica_masters=) and through
        # the gateway's replica filer, each marked stale
        t0 = time.perf_counter()
        (r_vids, r_fids), launches["geo.ec_encode_replica"] = counted(
            lambda: encode(r_master, cl_r, r_filer))
        bal_log("geo.ec_encode_replica", time.perf_counter() - t0,
                launches["geo.ec_encode_replica"], volumes=r_vids)
        _, launches["geo.drop_shards_replica"] = counted(
            lambda: drop(r_master, r_vids))
        r_victims = on_victims(cl_r, r_vids, r_fids)
        pf.stop()
        cl_p.stop_master()
        # what a reader may ask for: every version (current or not) of an
        # acknowledged PUT, by the replica's entries
        reads = []
        for path, (is_dir, vid, marker, _) in namespace.items():
            if is_dir or marker or not path.startswith("/buckets/geo/"):
                continue
            key, nid, size = acked[vid]
            current = path == f"/buckets/geo/{key}"
            reads.append((path, key, vid, current,
                          hashlib.sha256(payload(seed, nid, size))
                          .hexdigest()))
        lost = sorted(set(acked) - {r[2] for r in reads})
        if lost:
            raise AssertionError(f"acknowledged PUTs lost: {lost[:3]}")

        local = threading.local()

        def client_read(item) -> float:
            path, _, _, _, sha = item
            c = getattr(local, "client", None)
            if c is None:
                c = local.client = Client(p_master,
                                          replica_masters=r_master)
            t0 = time.perf_counter()
            chunks = sorted(fs_meta(r_filer, "lookup", path=path)["chunks"],
                            key=lambda ch: ch["offset"])
            data = b""
            for ch in chunks:
                data += c.download(ch["fid"])
                if not c.last_read_stale:
                    raise AssertionError(f"{path}: read not marked stale")
            if hashlib.sha256(data).hexdigest() != sha:
                raise AssertionError(f"{path}: the replica's bytes differ")
            return time.perf_counter() - t0

        def gateway_read(item) -> float:
            _, key, vid, current, sha = item
            t0 = time.perf_counter()
            r, _ = s3_call(gw.url, "GET", f"/geo/{key}" if current
                           else f"/geo/{key}?versionId={vid}", tally=tally)
            secs = time.perf_counter() - t0
            if r.status != 200 or r.headers.get("X-Seaweed-Stale-Ok") != "1":
                raise AssertionError(f"GET {key} {vid}: {r.status}, stale "
                                     f"{r.headers.get('X-Seaweed-Stale-Ok')}")
            if hashlib.sha256(r.data).hexdigest() != sha:
                raise AssertionError(f"GET {key} {vid}: bytes differ")
            return secs

        def failover(fn) -> dict:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(GEO_READERS) as ex:
                lat = list(ex.map(fn, reads))
            return {"wall": time.perf_counter() - t0, "lat": lat}

        for name, fn in (("geo.failover_client", client_read),
                         ("geo.failover_gateway", gateway_read)):
            fo, launches[name] = counted(lambda: failover(fn))
            bal_log(name, fo["wall"], launches[name], reads=len(reads),
                    current=sum(r[3] for r in reads),
                    stale_marked=len(reads), on_lost_shards=r_victims,
                    per_read=latency_summary(fo["lat"]))
        twice = [k for k, n in applies.items() if n > 1]
        summary = {
            "acknowledged_puts": len(acked),
            "acknowledged_puts_lost": len(lost),
            "objects_and_versions_equal": len(reads),
            "events_applied": sum(applies.values()),
            "events_applied_twice": len(twice),
            "events_looped": len(looped),
            "backfill_s": bf["secs"], "tail_s": tail_s,
            "events_per_s": events_per_s,
            "lag": latency_summary(steady_lag),
            "drill_lag": latency_summary(drill_lag),
            "answers": dict(tally.statuses)}
        if twice or looped:
            raise AssertionError(f"events applied twice {twice[:3]}, "
                                 f"looped {looped[:3]}")
    finally:
        geo_sink.ClusterSink.apply = orig_apply
        if drain is not None and drain.poll() is None:
            drain.kill()
            drain.wait()
        for proc in procs:
            proc.stop()
        for c in (cl_p, cl_r):
            if c is not None:
                c.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            if any(n for k, n in counts.items() if k != "gf_apply"):
                raise AssertionError(f"{step}: launches {counts}")
        must = ["geo.ec_encode_primary", "geo.ec_encode_replica"]
        if p_victims:
            must.append("geo.backfill")
        if r_victims:
            must += ["geo.failover_client", "geo.failover_gateway"]
        for step in must:
            if launches[step]["gf_apply"] == 0:
                raise AssertionError(f"{step}: no gf_apply launch")
    # the consume positions of replication, swept once nothing else of
    # the phase writes (the recorder patches the process's file calls)
    t0 = time.perf_counter()
    sweep, launches["geo.crash_offset_commit"] = counted(
        lambda: crash_harness.sweep_all(
            seeds=CRASH_SEEDS, points=MESH_CRASH_POINTS,
            workloads=[crash_wl.make_offset_workload()],
            scratch_dir=str(work / "crash")))
    bal_log("geo.crash_offset_commit", time.perf_counter() - t0,
            launches["geo.crash_offset_commit"],
            points=sweep["total_points"],
            violations=sweep["total_violations"])
    if not sweep["ok"] or sweep["total_violations"]:
        raise AssertionError(f"offset_commit: {sweep}")
    bal_log("geo.summary", time.perf_counter() - t_phase, launches,
            **summary, gf_apply_per_step={
                k: v["gf_apply"] for k, v in launches.items()},
            gf_apply_phase=sum(v["gf_apply"] for v in launches.values()))
    if coder_name == "auto" and not sum(
            v["gf_apply"] for v in launches.values()):
        raise AssertionError("phase 19 launched no gf_apply")
    shutil.rmtree(work, ignore_errors=True)
    return launches


GRPC_LIMIT_MB = 64
GRPC_CHUNK = 8 * MIB             # the CLI filer's chunks
GRPC_MAX_FILE = 8 * MIB          # phase 3's generator: log-uniform 1 KiB ..
GRPC_BYTES = 24 * MIB            # ... through the filer, by GRPC_WRITERS
GRPC_WRITERS = 4
GRPC_DOCS = 120                  # JSON documents for Query
GRPC_READERS = 8                 # degraded needle reads in flight
GRPC_RATE_MSGS = 200             # publishes timed per ack level
GRPC_KILL_MSGS = 200             # ack=flush publishes across the kill
GRPC_MSG = 512                   # bytes a message
GRPC_QUERY = ({"field": "n", "op": "<", "value": 500}, ["id", "n"])


def grpc_stub(kind: str, http_url: str):
    """A sync channel to the gRPC twin of `http_url` and its stub."""
    from seaweedfs_torch.pb import rpc
    ch = rpc.dial(rpc.grpc_address(http_url))
    stub = {"master": rpc.MasterStub, "volume": rpc.VolumeServerStub,
            "filer": rpc.FilerStub}[kind](ch)
    return ch, stub


def grpc_ok(resp, what: str):
    if not resp.ok:
        raise AssertionError(f"{what}: {resp.error}")
    return resp


def grpc_ec_encode(client, vids: list, collection: str = "") -> dict:
    """ec.encode of `vids` with every step a gRPC call of the volume
    servers' (VolumeMarkReadonly, VolumeEcShardsGenerate on the holder,
    VolumeEcShardsCopy and VolumeEcShardsMount on the targets of the
    shell's spread, VolumeDelete of the original, VolumeEcShardsDelete of
    the holder's surplus); returns vid -> {url: shard ids}."""
    from seaweedfs_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_torch.shell import ec_commands
    nodes = ec_commands.collect_ec_nodes(client.dir_status())
    plans = {}
    for vid in vids:
        holder = client.lookup(vid)[0]
        plan = ec_commands.plan_shard_spread(nodes, 14, holder)
        chans = {}
        try:
            for url in set(plan) | {holder}:
                chans[url] = grpc_stub("volume", url)
            stub = chans[holder][1]
            ref = vpb.VolumeRef(volume_id=vid, collection=collection)
            grpc_ok(stub.VolumeMarkReadonly(ref), f"readonly {vid}")
            grpc_ok(stub.VolumeEcShardsGenerate(vpb.EcGenerateRequest(
                volume_id=vid, collection=collection)), f"generate {vid}")
            for url, sids in plan.items():
                t = chans[url][1]
                if url != holder:
                    grpc_ok(t.VolumeEcShardsCopy(vpb.EcCopyRequest(
                        volume_id=vid, collection=collection,
                        shard_ids=sids, copy_ecx_file=True,
                        source_data_node=holder)), f"copy {vid} to {url}")
                grpc_ok(t.VolumeEcShardsMount(vpb.EcShardsRequest(
                    volume_id=vid, collection=collection, shard_ids=sids)),
                    f"mount {vid} on {url}")
            grpc_ok(stub.VolumeDelete(ref), f"delete {vid}")
            surplus = [s for s in range(14) if s not in plan.get(holder, [])]
            if surplus:
                grpc_ok(stub.VolumeEcShardsDelete(vpb.EcShardsRequest(
                    volume_id=vid, collection=collection,
                    shard_ids=surplus)), f"surplus {vid}")
        finally:
            for ch, _ in chans.values():
                ch.close()
        plans[vid] = plan
    return plans


def grpc_lookup_ec(master: str, vid: int) -> dict:
    """shard id -> holder urls, from the master's gRPC LookupEc."""
    from seaweedfs_torch.pb import master_pb2 as mpb
    ch, stub = grpc_stub("master", master)
    try:
        out = stub.LookupEc(mpb.LookupEcRequest(volume_id=vid))
    finally:
        ch.close()
    return {s.shard_id: [loc.url for loc in s.locations]
            for s in out.shards}


def grpc_drop(master: str, vids: list, collection: str = "") -> None:
    """VolumeEcShardsDelete of VICTIMS on their holders, over gRPC."""
    from seaweedfs_torch.pb import volume_server_pb2 as vpb
    for vid in vids:
        shards = grpc_lookup_ec(master, vid)
        for sid in VICTIMS:
            ch, stub = grpc_stub("volume", shards[sid][0])
            try:
                grpc_ok(stub.VolumeEcShardsDelete(vpb.EcShardsRequest(
                    volume_id=vid, collection=collection, shard_ids=[sid])),
                    f"drop {vid}.{sid}")
            finally:
                ch.close()
    wait_until(lambda: all(len(grpc_lookup_ec(master, v))
                           == 14 - len(VICTIMS) for v in vids),
               "the master drops the four shards", timeout=60)


def shard_fetches(cl) -> dict:
    """ec_shard_fetch by route, summed over the cluster's volume
    servers."""
    return {route: sum(n[0].metrics.value("ec_shard_fetch",
                                          {"route": route})
                       for n in cl.nodes if n[0] is not None)
            for route in ("grpc", "http")}


def check_rebuilt_with_plain(base: str, victims: tuple,
                             device: torch.device) -> int:
    """The rebuilt shard files equal the plain version's reconstruction
    of the victims from the first 10 survivors, in 8 MiB batches on
    `device`; returns the bytes checked a shard."""
    k, m = 10, 4
    present = [i for i in range(k + m) if i not in victims][:k]
    w = rs_torch.load_matrix(gf256.reconstruction_matrix(
        k, m, present, list(victims)), device)
    size = os.path.getsize(base + geometry.to_ext(0))
    srcs = [open(base + geometry.to_ext(i), "rb") for i in present]
    outs = [open(base + geometry.to_ext(v), "rb") for v in victims]
    try:
        for off in range(0, size, 8 * MIB):
            n = min(8 * MIB, size - off)
            x = torch.from_numpy(np.stack(
                [np.frombuffer(f.read(n), np.uint8) for f in srcs]))
            want = rs_torch.gf_apply(w, x.to(device)).cpu().numpy()
            got = np.stack([np.frombuffer(f.read(n), np.uint8)
                            for f in outs])
            if not np.array_equal(want, got):
                raise AssertionError(f"{base}: rebuilt shards differ from "
                                     f"the plain version at {off}")
        return size
    finally:
        for f in srcs + outs:
            f.close()


def run_grpc(work: Path, seed: int = SEED + 20, coder_name: str = "auto",
             device=None, limit_mb: int = GRPC_LIMIT_MB,
             total: int = GRPC_BYTES, max_file: int = GRPC_MAX_FILE,
             chunk: int = GRPC_CHUNK, docs: int = GRPC_DOCS,
             rate_msgs: int = GRPC_RATE_MSGS,
             kill_msgs: int = GRPC_KILL_MSGS) -> dict:
    """Phase 20; returns the launches per step. On the card they are held
    to the phase's rule (gf_apply in the gRPC encodes and rebuild, in the
    degraded reads and Query, in the topic's replay where a segment lies
    on a lost shard, more than 0 in the phase; no other kernel); needles
    and documents must lie on the lost shards on any host;
    ``coder_name="torch", device="cpu"`` at a few MB runs it on a host
    without one (no launch is counted there; `chunk` whole MiB, as the
    CLI filer takes it)."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_torch.balance import BalanceConfig
    from seaweedfs_torch.filer.filer import MetaEvent
    from seaweedfs_torch.messaging import client as msg_client
    from seaweedfs_torch.messaging.fake_kafka import FakeKafkaServer
    from seaweedfs_torch.notification.queues import KafkaQueue
    from seaweedfs_torch.pb import master_pb2 as mpb
    from seaweedfs_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_torch.replication import sub as rep_sub
    from seaweedfs_torch.replication.replicator import (Replicator,
                                                        run_from_queue)
    from seaweedfs_torch.replication.sink import LocalSink
    from seaweedfs_torch.utils.config import Configuration
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    plain_dev = torch.device("cpu") if device in (None, "cpu") and \
        coder_name != "auto" else torch.device("cuda", 0)
    launches: dict = {}
    files = FsFiles(seed)
    rng = np.random.default_rng(seed)
    cl = kafka = None
    procs: list = []
    try:
        # a master and 3 volume servers on 2 racks in this process (their
        # launches count), every one with its gRPC port, the volume
        # servers beating over the master's gRPC Heartbeat stream
        cl = LocalCluster(3, coder_name=coder_name, device=device,
                          volume_size_limit_mb=limit_mb, pulse=0.5,
                          directory=str(work / "cluster"), racks=2,
                          use_grpc_heartbeat=True,
                          master_kwargs={"repair_enabled": False,
                                         "balance_config": BalanceConfig(
                                             force_enabled=False)})
        master = cl.master_url
        client = Client(master)
        f_url = f"127.0.0.1:{free_port()}"
        b_urls = [f"127.0.0.1:{free_port()}" for _ in range(2)]
        fcwd = work / "filer_cwd"
        fcwd.mkdir()
        (fcwd / "notification.toml").write_text(
            f'[notification.broker]\nenabled = true\n'
            f'brokers = "{",".join(b_urls)}"\nfiler = "{f_url}"\n'
            f'namespace = "notifications"\ntopic = "filer"\n')
        filer = CliFiler(work, [
            "filer", "-mserver", master, "-store", "leveldb2",
            "-store_path", str(work / "filer_leveldb2"), "-chunk_size_mb",
            cli_chunk_mb(chunk)], name="filer",
            port=int(f_url.rsplit(":", 1)[1]), cwd=fcwd)
        brokers = [CliFiler(work, ["msg.broker", "-filer", f_url],
                            name=f"broker{i}",
                            port=int(u.rsplit(":", 1)[1]))
                   for i, u in enumerate(b_urls)]
        procs = [filer, *brokers]
        for proc in procs:
            proc.start()
        for proc in procs:
            wait_until(proc.up, f"the CLI {proc.name}", timeout=120)

        def registered() -> list:
            return sorted(fs_meta(f_url, "brokers")["brokers"])

        wait_until(lambda: registered() == sorted(b_urls) and all(
            sorted(http.get_json(f"http://{u}/topics")[1]["brokers"])
            == sorted(b_urls) for u in b_urls),
            "both brokers registered and agreed", timeout=60)
        log({"phase": "grpc.setup", "seconds": time.perf_counter() - t_phase,
             "master": master, "filer": f_url, "brokers": b_urls,
             "grpc_heartbeat": [n[0].use_grpc_heartbeat for n in cl.nodes],
             "card": SMI[0]})

        # (20a) the master over gRPC: Assign, Lookup, KeepConnected (the
        # snapshot, then the delta of a new volume), ClusterStatus
        def master_plane() -> dict:
            ch, stub = grpc_stub("master", master)
            try:
                t0 = time.perf_counter()
                a = stub.Assign(mpb.AssignRequest(count=1))
                if a.error or not a.fid:
                    raise AssertionError(f"Assign: {a.error}")
                vid = int(a.fid.split(",")[0])
                lk = stub.Lookup(mpb.LookupRequest(volume_id=vid))
                if [loc.url for loc in lk.locations] != [a.url]:
                    raise AssertionError(f"Lookup {vid}: {lk}")
                st = stub.ClusterStatus(mpb.ClusterStatusRequest())
                if not st.is_leader or st.leader != master:
                    raise AssertionError(f"ClusterStatus: {st}")
                stream = stub.KeepConnected(
                    mpb.KeepConnectedRequest(client_name="smoke"),
                    timeout=60)
                snap = set()
                msg = next(stream)
                while msg.is_snapshot:
                    snap.add(msg.url)
                    if len(snap) == len(cl.nodes):
                        break
                    msg = next(stream)
                if len(snap) != len(cl.nodes) or vid not in {
                        v for n in cl.master.topology.nodes.values()
                        for v in n.volumes}:
                    raise AssertionError(f"KeepConnected snapshot {snap}")
                t_grow = time.perf_counter()
                threading.Thread(target=lambda: http.get_json(
                    f"http://{master}/vol/grow?count=1&collection=grpcgrow"),
                    daemon=True).start()
                delta = None
                for msg in stream:
                    if not msg.is_snapshot and msg.new_vids:
                        delta = list(msg.new_vids)
                        break
                stream.cancel()
                if not delta or msg.leader != master:
                    raise AssertionError(f"KeepConnected delta {msg}")
                return {"secs": time.perf_counter() - t0,
                        "delta_s": time.perf_counter() - t_grow,
                        "snapshot_nodes": len(snap), "delta_vids": delta,
                        "brokers": registered()}
            finally:
                ch.close()

        mp_, launches["grpc.master"] = counted(master_plane)
        bal_log("grpc.master", mp_.pop("secs"), launches["grpc.master"],
                **mp_)

        # (20b) uploads through the filer, its events through the broker
        # topic into filer.replicate's [source.broker] input and a local
        # sink: every event applied once, the sink equal to the uploads
        sizes = fs_sizes(rng, total, 1024, max_file)
        for i, size in enumerate(sizes):
            files.add(f"/data/f{i:03d}.bin", size)
        doc_rng = np.random.default_rng((seed, 1))
        doc_bodies = {}
        for i in range(docs):
            pad = "x" * int(doc_rng.integers(100, 2000))
            # no .json name: the volume server would store it gzipped,
            # and Query (both packages', as upstream's) reads the raw
            # needle
            doc_bodies[f"/docs/d{i:04d}"] = json.dumps(
                {"id": i, "n": int(doc_rng.integers(0, 1000)),
                 "pad": pad}).encode()

        def upload() -> dict:
            t0 = time.perf_counter()

            def one(item) -> None:
                path, data = item
                status, _, body = fs_put(f_url, path, data)
                if status not in (200, 201):
                    raise AssertionError(f"PUT {path}: {status} {body}")

            # the documents first: they open the volumes, in the first
            # small block of each, which is shard 0's, one of VICTIMS,
            # so Query reconstructs them
            items = list(doc_bodies.items()) + \
                [(p, files.data(p)) for p in files.files]
            with ThreadPoolExecutor(GRPC_WRITERS) as ex:
                list(ex.map(one, items))
            secs = time.perf_counter() - t0
            nbytes = sum(len(d) for _, d in items)
            return {"secs": secs, "files": len(items), "bytes": nbytes,
                    "gbps": nbytes / secs / 1e9}

        up, launches["grpc.upload"] = counted(upload)
        bal_log("grpc.upload", up.pop("secs"), launches["grpc.upload"],
                **up)

        rcfg = Configuration({"source": {"broker": {
            "enabled": True, "brokers": ",".join(b_urls),
            "namespace": "notifications", "topic": "filer",
            "position_path": str(work / "broker.pos")}}})
        applied: collections.Counter = collections.Counter()
        consumed: list = []
        want_tree = {p: hashlib.sha256(files.data(p)).hexdigest()
                     for p in files.files}
        want_tree.update({p: hashlib.sha256(d).hexdigest()
                          for p, d in doc_bodies.items()})

        def sink_tree(d: Path) -> dict:
            got = {}
            for dirpath, _, names in os.walk(d):
                for name in names:
                    full = os.path.join(dirpath, name)
                    got["/" + os.path.relpath(full, d)] = sha256_file(full)
            return got

        def drain(inp, sink_dir: Path, record: bool) -> dict:
            r = Replicator(f_url, LocalSink(str(sink_dir)), "/")
            orig = r.apply

            def apply(ev) -> None:
                orig(ev)
                applied[(str(sink_dir), ev.tsns)] += 1
                if record:
                    consumed.append(ev)

            r.apply = apply
            t0 = time.perf_counter()
            n = 0
            deadline = time.monotonic() + 120
            while sink_tree(sink_dir) != want_tree:
                if time.monotonic() > deadline:
                    got = sink_tree(sink_dir)
                    diff = sorted(set(got.items()) ^ set(want_tree.items()))
                    raise AssertionError(f"{sink_dir.name}: {diff[:4]}")
                n += run_from_queue(r, inp, idle_timeout=1.0)
            secs = time.perf_counter() - t0
            twice = [k for k, c in applied.items()
                     if k[0] == str(sink_dir) and c > 1]
            if twice:
                raise AssertionError(f"applied twice: {twice[:3]}")
            return {"secs": secs, "events": n, "events_per_s": n / secs,
                    "files": len(want_tree), "applied_twice": len(twice)}

        rep, launches["grpc.replicate"] = counted(lambda: drain(
            rep_sub.load_notification_input(rcfg), work / "sink_broker",
            True))
        bal_log("grpc.replicate", rep.pop("secs"),
                launches["grpc.replicate"], **rep, events_lost=0)

        # (20c) the volumes of the uploads encoded over gRPC (every step
        # a volume server's RPC), then VolumeEcShardsDelete of VICTIMS
        fids = dav_fids(f_url, list(files.files) + list(doc_bodies))
        vids = sorted({int(f.split(",")[0]) for fl in fids.values()
                       for f in fl})
        t0 = time.perf_counter()
        plans, launches["grpc.ec_encode"] = counted(
            lambda: grpc_ec_encode(client, vids))
        wait_until(lambda: all(len(grpc_lookup_ec(master, v)) == 14
                               for v in vids), "14 shards listed", 60)
        bal_log("grpc.ec_encode", time.perf_counter() - t0,
                launches["grpc.ec_encode"], volumes=vids,
                spread={v: {u: len(s) for u, s in p.items()}
                        for v, p in plans.items()})
        shard_sha = {}
        for vid in vids:
            for sid, urls in grpc_lookup_ec(master, vid).items():
                i = cl.index_of(urls[0])
                shard_sha[(vid, sid)] = sha256_file(os.path.join(
                    cl.nodes[i][3], f"{vid}{geometry.to_ext(sid)}"))
        _, launches["grpc.drop_shards"] = counted(
            lambda: grpc_drop(master, vids))
        def on_victims(some: list) -> int:
            """Needles of `some` fids with an interval on VICTIMS."""
            count = 0
            for vid in sorted({int(f.split(",")[0]) for f in some}):
                ev = next(ev for ev in (cl.store(i).find_ec_volume(vid)
                                        for i in range(len(cl.nodes)))
                          if ev is not None)
                count += needles_on_shards(
                    ev, [f for f in some if int(f.split(",")[0]) == vid],
                    set(), VICTIMS)
            return count

        victims_on = on_victims([f for fl in fids.values() for f in fl])
        docs_on = on_victims([fids[p][0] for p in doc_bodies])
        if not victims_on or not docs_on:
            raise AssertionError(f"{victims_on} needles, {docs_on} documents "
                                 "on the lost shards: want both above 0")

        # (20d) every needle read back with 4 shards lost: each survivor
        # interval fetched from its holder over VolumeEcShardRead, none
        # over /admin/ec/shard_read; Query over gRPC against /admin/query
        before = shard_fetches(cl)
        needles = [(f, p) for p, fl in fids.items() for f in fl]

        def read_needles() -> dict:
            local = threading.local()
            wants = {p: (files.data(p) if p in files.files
                         else doc_bodies[p]) for p in fids}
            offsets = {}
            for p, fl in fids.items():
                chunks = sorted(fs_meta(f_url, "lookup", path=p)["chunks"],
                                key=lambda c: c["offset"])
                for c in chunks:
                    offsets[c["fid"]] = (c["offset"], c["size"])

            def one(item) -> float:
                fid, path = item
                c = getattr(local, "client", None)
                if c is None:
                    c = local.client = Client(master)
                t0 = time.perf_counter()
                data = c.download(fid)
                secs = time.perf_counter() - t0
                off, size = offsets[fid]
                if data != wants[path][off:off + size]:
                    raise AssertionError(f"{path} {fid}: bytes differ")
                return secs

            t0 = time.perf_counter()
            with ThreadPoolExecutor(GRPC_READERS) as ex:
                lat = list(ex.map(one, needles))
            return {"wall": time.perf_counter() - t0, "lat": lat}

        rd, launches["grpc.read_degraded"] = counted(read_needles)
        after = shard_fetches(cl)
        fetch = {k: after[k] - before[k] for k in after}
        bal_log("grpc.read_degraded", rd["wall"],
                launches["grpc.read_degraded"], needles=len(needles),
                on_lost_shards=victims_on, shard_fetch=fetch,
                per_needle=latency_summary(rd["lat"]))
        if fetch["http"] or not fetch["grpc"]:
            raise AssertionError(f"survivor fetches {fetch}: want gRPC "
                                 "only")
        # the same reads with every peer's gRPC port taken for dead: the
        # survivors come over /admin/ec/shard_read, the route phase 18's
        # degraded queries take (the two routes side by side, one host)
        # (grpc, http, http, grpc: the first read of each route pays its
        # warm-up on one side only)
        servers = [n[0] for n in cl.nodes]
        ab: dict = {"grpc": [rd["lat"]], "http": []}
        for step, route in (("grpc.read_degraded_http", "http"),
                            ("grpc.read_degraded_http2", "http"),
                            ("grpc.read_degraded_grpc2", "grpc")):
            if route == "http":
                for vs in servers:
                    vs._peer_grpc_dead.update(
                        {u.url: time.time() + 3600 for u in servers})
            try:
                before_r = shard_fetches(cl)
                rr, launches[step] = counted(read_needles)
                after_r = shard_fetches(cl)
            finally:
                for vs in servers:
                    vs._peer_grpc_dead.clear()
            fetch_r = {k: after_r[k] - before_r[k] for k in after_r}
            ab[route].append(rr["lat"])
            bal_log(step, rr["wall"], launches[step], needles=len(needles),
                    shard_fetch=fetch_r,
                    per_needle=latency_summary(rr["lat"]))
            other = "grpc" if route == "http" else "http"
            if fetch_r[other] or not fetch_r[route]:
                raise AssertionError(f"{step}: survivor fetches {fetch_r}")
        rdh = {"lat": [t for lat in ab["http"] for t in lat]}

        doc_fids = [fids[p][0] for p in sorted(doc_bodies)]

        def query() -> dict:
            flt, proj = GRPC_QUERY
            target = cl.url(0)
            t0 = time.perf_counter()
            ch, stub = grpc_stub("volume", target)
            try:
                lines = []
                for chunk_ in stub.Query(vpb.QueryRequest(
                        file_ids=doc_fids, filter_json=json.dumps(flt),
                        selections=proj), timeout=300):
                    if chunk_.error:
                        raise AssertionError(f"Query: {chunk_.error}")
                    lines.append(bytes(chunk_.data))
            finally:
                ch.close()
            grpc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = http.request("POST", f"http://{target}/admin/query",
                             json.dumps({"fids": doc_fids, "filter": flt,
                                         "projections": proj}).encode(),
                             {"Content-Type": "application/json"},
                             timeout=300)
            http_s = time.perf_counter() - t0
            got = b"".join(lines).splitlines()
            if r.status != 200 or got != r.data.splitlines():
                raise AssertionError("Query over gRPC differs from "
                                     "/admin/query")
            want = [json.dumps({k: json.loads(d)[k] for k in proj},
                               separators=(",", ":"))
                    for p, d in sorted(doc_bodies.items())
                    if json.loads(d)["n"] < flt["value"]]
            if len(got) != len(want):
                raise AssertionError(f"Query: {len(got)} of {len(want)}")
            return {"grpc_s": grpc_s, "http_s": http_s, "docs": len(doc_fids),
                    "matched": len(got)}

        qy, launches["grpc.query"] = counted(query)
        bal_log("grpc.query", qy["grpc_s"], launches["grpc.query"], **qy,
                docs_on_lost_shards=docs_on)

        # (20e) VolumeEcShardsRebuild over gRPC on the rebuilder, after
        # VolumeEcShardsCopy of the survivors it lacks; the rebuilt files
        # equal the encode's and the plain version's reconstruction
        def rebuild() -> dict:
            from seaweedfs_torch.shell import ec_commands
            out = {}
            for vid in vids:
                nodes = ec_commands.collect_ec_nodes(client.dir_status())
                rebuilder, missing, copy_plan = ec_commands.plan_rebuild(
                    nodes, vid, 14)
                if sorted(missing) != list(VICTIMS):
                    raise AssertionError(f"{vid} misses {missing}")
                ch, stub = grpc_stub("volume", rebuilder)
                try:
                    for src, sids in copy_plan.items():
                        grpc_ok(stub.VolumeEcShardsCopy(vpb.EcCopyRequest(
                            volume_id=vid, shard_ids=sids,
                            source_data_node=src)), f"copy {vid}")
                    rb = stub.VolumeEcShardsRebuild(vpb.EcRebuildRequest(
                        volume_id=vid))
                    if rb.error or sorted(rb.rebuilt_shard_ids) != \
                            list(VICTIMS):
                        raise AssertionError(f"rebuild {vid}: {rb}")
                    grpc_ok(stub.VolumeEcShardsMount(vpb.EcShardsRequest(
                        volume_id=vid, shard_ids=list(VICTIMS))),
                        f"mount rebuilt {vid}")
                finally:
                    ch.close()
                base = os.path.join(cl.nodes[cl.index_of(rebuilder)][3],
                                    str(vid))
                for sid in VICTIMS:
                    if sha256_file(base + geometry.to_ext(sid)) != \
                            shard_sha[(vid, sid)]:
                        raise AssertionError(f"rebuilt {vid}.{sid} differs")
                out[vid] = check_rebuilt_with_plain(base, VICTIMS,
                                                    plain_dev)
            return out

        t0 = time.perf_counter()
        rebuilt, launches["grpc.rebuild"] = counted(rebuild)
        bal_log("grpc.rebuild", time.perf_counter() - t0,
                launches["grpc.rebuild"], shard_bytes=rebuilt,
                equal_to_plain=True)

        # (20f) publishes per ack level; then an ack=flush stream to a
        # partition one broker owns, that broker SIGKILLed mid-stream:
        # the survivor takes the partition over, the subscriber resumes
        # from the filer's segments, no acknowledged message is lost;
        # the topic's volumes encoded with 4 shards lost, and the topic
        # replays whole
        def rates() -> dict:
            out = {}
            for ack in ("memory", "flush"):
                pub = msg_client.Publisher(b_urls, "smoke", f"rate{ack}",
                                           partition_count=1, ack=ack)
                t0 = time.perf_counter()
                for i in range(rate_msgs):
                    pub.publish(b"k", payload(seed, 10_000 + i, GRPC_MSG))
                out[ack] = rate_msgs / (time.perf_counter() - t0)
            return out

        rt, launches["grpc.publish_rates"] = counted(rates)
        bal_log("grpc.publish_rates", 0.0, launches["grpc.publish_rates"],
                publishes_per_s=rt, messages=rate_msgs, bytes=GRPC_MSG)

        ordered = sorted(b_urls)
        topic = next(f"kill{i}" for i in range(100)
                     if msg_client.pick_broker(ordered, "smoke", f"kill{i}",
                                               0) == b_urls[0])
        victim_proc, survivor = brokers[0], b_urls[1]

        def kill_drill() -> dict:
            acked: dict = {}
            seen: dict = {}
            sub_err: list = []
            retried = [0]
            stop = threading.Event()

            def subscribe_owner() -> None:
                try:
                    for e in msg_client.Subscriber(
                            [b_urls[0]], "smoke", topic).stream(
                                since=0, timeout=30):
                        seen[e.value] = e.ts_ns
                        if stop.is_set():
                            return
                except Exception as e:  # the broker died under the stream
                    sub_err.append(repr(e))

            reader = threading.Thread(target=subscribe_owner, daemon=True)
            reader.start()
            pub = msg_client.Publisher(list(b_urls), "smoke", topic,
                                       partition_count=1, filer=f_url,
                                       ack="flush")
            t0 = time.perf_counter()
            killed_at = None
            for i in range(kill_msgs):
                if i == kill_msgs // 3:
                    victim_proc.kill()
                    killed_at = time.perf_counter()
                value = payload(seed, 20_000 + i, GRPC_MSG)
                # a client keeps its message: a publish that failed over
                # every broker it knew is sent again (it may land twice)
                for attempt in range(3):
                    try:
                        acked[value] = pub.publish(b"k", value)
                        break
                    except OSError:
                        if attempt == 2:
                            raise
                        retried[0] += 1
            publish_s = time.perf_counter() - t0
            stop.set()
            reader.join(60)
            last = max(seen.values()) if seen else 0
            got = dict(seen)
            # the broker reads the segments since `last` from the filer
            # before its first line: wait for what was acknowledged
            for e in msg_client.Subscriber([survivor], "smoke", topic) \
                    .stream(since=last, timeout=120):
                got[e.value] = e.ts_ns
                if all(v in got for v in acked):
                    break
            lost = [v for v in acked if v not in got]
            if lost:
                raise AssertionError(f"{len(lost)} acknowledged messages "
                                     "lost across the broker's kill")
            owner = msg_client.pick_broker(
                sorted(fs_meta(f_url, "brokers")["brokers"]), "smoke",
                topic, 0)
            if owner != survivor:
                raise AssertionError(f"the partition is on {owner}")
            return {"secs": publish_s, "acked": len(acked),
                    "before_kill_read": len(seen),
                    "resumed_from": last, "lost": len(lost),
                    "takeover_s": time.perf_counter() - killed_at,
                    "publishes_retried": retried[0],
                    "subscriber_broke": sub_err[:1]}

        kd, launches["grpc.broker_kill"] = counted(kill_drill)
        bal_log("grpc.broker_kill", kd.pop("secs"),
                launches["grpc.broker_kill"], **kd)

        seg_dir = f"/topics/smoke/{topic}/0000"
        seg_fids = dav_fids(f_url, [p for p, v in fs_walk(
            f_url, seg_dir).items() if not v["attr"]["mode"] & 0o40000])
        seg_vids = sorted({int(f.split(",")[0]) for fl in seg_fids.values()
                           for f in fl})
        seg_list = [f for fl in seg_fids.values() for f in fl]
        t0 = time.perf_counter()
        _, launches["grpc.ec_encode_topic"] = counted(
            lambda: grpc_ec_encode(client, seg_vids))
        wait_until(lambda: all(len(grpc_lookup_ec(master, v)) == 14
                               for v in seg_vids), "14 shards listed", 60)
        _, launches["grpc.drop_shards_topic"] = counted(
            lambda: grpc_drop(master, seg_vids))
        segs_on = on_victims(seg_list)
        bal_log("grpc.ec_encode_topic", time.perf_counter() - t0,
                launches["grpc.ec_encode_topic"], volumes=seg_vids,
                segments=len(seg_fids), on_lost_shards=segs_on)

        def replay() -> dict:
            t0 = time.perf_counter()
            want = {payload(seed, 20_000 + i, GRPC_MSG)
                    for i in range(kill_msgs)}
            values = []
            # every segment is read from the filer (with 4 shards lost)
            # before the broker's first line: a long idle bound
            for e in msg_client.Subscriber([survivor], "smoke",
                                           topic).stream(since=0,
                                                         timeout=300):
                values.append(e.value)
                if want <= set(values):
                    break
            missing = want - set(values)
            if missing:
                raise AssertionError(f"the replay misses {len(missing)}")
            return {"secs": time.perf_counter() - t0,
                    "messages": len(values),
                    "repeated": len(values) - len(set(values))}

        rp, launches["grpc.broker_replay"] = counted(replay)
        bal_log("grpc.broker_replay", rp.pop("secs"),
                launches["grpc.broker_replay"], **rp)

        # (20g) the same events through a Kafka topic (in-repo broker):
        # KafkaQueue -> KafkaQueueInput -> the replicator, 0 lost, 0
        # repeated
        kafka = FakeKafkaServer()

        def via_kafka() -> dict:
            q = KafkaQueue(kafka.addr, topic="filer")
            for ev in consumed:
                q.notify(MetaEvent.from_dict(ev.to_dict()))
            q.close()
            out = drain(rep_sub.KafkaQueueInput(
                kafka.addr, topic="filer",
                position_path=str(work / "kafka.pos")),
                work / "sink_kafka", False)
            if out["events"] != len(consumed):
                raise AssertionError(f"kafka: {out['events']} of "
                                     f"{len(consumed)} events applied")
            return out

        kf, launches["grpc.kafka"] = counted(via_kafka)
        bal_log("grpc.kafka", kf.pop("secs"), launches["grpc.kafka"],
                **kf, events_lost=0)
        summary = {"files": len(want_tree),
                   "shard_fetch": fetch,
                   "degraded_per_needle": latency_summary(
                       [t for lat in ab["grpc"] for t in lat]),
                   "degraded_per_needle_http": latency_summary(rdh["lat"]),
                   "publishes_per_s": rt,
                   "replicate_events_per_s": rep["events_per_s"],
                   "acknowledged_messages_lost": kd["lost"],
                   "events_applied_twice": 0}
    finally:
        if kafka is not None:
            kafka.close()
        for proc in procs:
            proc.stop()
        if cl is not None:
            cl.shutdown()
    if coder_name == "auto":
        for step, counts in launches.items():
            if any(n for k, n in counts.items() if k != "gf_apply"):
                raise AssertionError(f"{step}: launches {counts}")
        must = ["grpc.ec_encode", "grpc.rebuild", "grpc.ec_encode_topic",
                "grpc.read_degraded", "grpc.read_degraded_http",
                "grpc.read_degraded_http2", "grpc.read_degraded_grpc2",
                "grpc.query"]
        if segs_on:
            must.append("grpc.broker_replay")
        for step in must:
            if launches[step]["gf_apply"] == 0:
                raise AssertionError(f"{step}: no gf_apply launch")
    bal_log("grpc.summary", time.perf_counter() - t_phase, launches,
            **summary, gf_apply_per_step={
                k: v["gf_apply"] for k, v in launches.items()},
            gf_apply_phase=sum(v["gf_apply"] for v in launches.values()))
    if coder_name == "auto" and not sum(
            v["gf_apply"] for v in launches.values()):
        raise AssertionError("phase 20 launched no gf_apply")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    SMI[0] = smi
    log({"phase": "device", "name": card, "count": count, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    lib = _build.build()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "library": lib.name})
    WORD_OPS[0] = word_ops_per_s()
    try:
        apply_ops, mxu_ops = sass_ops(lib)
        SASS_OPS.update(apply_ops)
        MXU_SASS.update(mxu_ops)
    except (OSError, subprocess.CalledProcessError, StopIteration,
            ValueError) as e:
        # ops_per_column then reads None
        log({"phase": "sass_ops", "error": repr(e)})
    log({"phase": "rates", "int32_ops_per_s": WORD_OPS[0],
         "gf_apply_sass_alu": SASS_OPS or "not measured",
         "gf_apply_mxu_sass_per_16_columns": MXU_SASS or "not measured",
         "gf_apply_ops_per_column_rs10_4": gf_apply_ops_per_column(10)})

    # wall seconds of each phase, logged before the kernels line
    phase_seconds: dict = {}
    since = [t0]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_seconds[name] = now - since[0]
        since[0] = now

    checked = check_kernels(device)
    mark("1-2")
    with env_set(WEED_EC_FORMULATION=None):
        coder = coder_mod.get_coder("auto", 10, 4)
    with env_set(WEED_EC_FORMULATION="xorsched"):
        auto_x = coder_mod.get_coder("auto", 10, 4)
    if not isinstance(coder, coder_mod.TorchCoder) or \
            coder.device.type != "cuda" or coder.formulation != "bitplane":
        raise AssertionError(f"auto coder is {coder!r}")
    if not isinstance(auto_x, coder_mod.TorchCoder) or \
            auto_x.formulation != "xorsched":
        raise AssertionError("auto coder under WEED_EC_FORMULATION="
                             "xorsched is not the xorsched coder")
    log({"phase": "auto_coder", "unpinned": coder.formulation,
         "pinned_xorsched": auto_x.formulation})
    coder_x = coder_mod.TorchCoder(10, 4, formulation="xorsched")

    shutil.rmtree(WORK, ignore_errors=True)
    launches = {}
    try:
        volume = source_volume(WORK / "src", MAIN_VOLUME_BYTES, 4 * MIB,
                               SEED, "")
        log({"phase": "disk", "free_bytes": shutil.disk_usage(WORK).free})
        launches["bitplane"], sha_b = run_main_path(
            WORK / "default", coder, geometry.DEFAULT, volume, device, "",
            min_on_victims=200)
        shutil.rmtree(WORK / "default", ignore_errors=True)
        launches["xorsched"], sha_x = run_main_path(
            WORK / "xorsched", coder_x, geometry.DEFAULT, volume, device,
            "xorsched.", min_on_victims=200)
        shutil.rmtree(WORK / "xorsched", ignore_errors=True)
        if sha_x != sha_b:
            raise AssertionError("xorsched shard files differ from the "
                                 "bitplane run's")
        log({"phase": "formulations_agree", "shards": len(sha_b),
             "sha256_equal": True})
        launches["governed"] = run_governed(
            WORK / "governed", coder, geometry.DEFAULT, volume, sha_b,
            device)
        shutil.rmtree(WORK / "src", ignore_errors=True)
        mixed = geometry.Geometry(large_block_size=262144,
                                  small_block_size=16384)
        volume = source_volume(WORK / "mixed_src", 4 * MIB, 256 * 1024,
                               SEED + 1, "mixed_tier.")
        sha = {}
        for tag, c in [("mixed_tier.", coder),
                       ("mixed_tier.xorsched.", coder_x)]:
            _, sha[tag] = run_main_path(WORK / tag, c, mixed, volume,
                                        device, tag)
        if sha["mixed_tier."] != sha["mixed_tier.xorsched."]:
            raise AssertionError("mixed-tier xorsched shards differ")
        shutil.rmtree(WORK, ignore_errors=True)
        mark("3-4")
        # phase 6 under the default policy and formulation
        with env_set(WEED_EC_GEOMETRY=None, WEED_EC_FORMULATION=None,
                     WEED_EC_MESH_DEVICES=None):
            launches["store"] = run_store_default(WORK / "store", device)
            launches["fused"] = run_store_archive(
                WORK / "fused", device, total=SMALL_VOLUME_BYTES)
            mark("6")
            # phase 7: the same path through the servers, the shell and
            # the CLI
            launches["cluster"] = run_cluster(WORK / "cluster", device,
                                              total=CUT_VOLUME_BYTES)
            run_cli(WORK / "cli")
            mark("7-8")
            # phase 9: the self-driving warm tier, its own cluster
            launches["lifecycle"] = run_lifecycle(
                WORK / "lifecycle", total=SMALL_VOLUME_BYTES,
                limit_mb=SMALL_VOLUME_BYTES // MIB)
            check_lifecycle_launches(launches["lifecycle"])
            mark("9")
            # phase 10: the multi-card coder and the crash sweeps
            launches["mesh"] = run_mesh(WORK / "mesh", device, card, count)
            mark("10")
            # phase 11: the auto-balancer and the volume server's data
            # path, its own cluster
            launches["balance"] = run_balance(WORK / "balance")
            check_balance_launches(launches["balance"])
            mark("11")
            # phase 12: the rest of the storage engine
            launches["storage"] = run_storage(WORK / "storage")
            mark("12")
            # phase 13: HA masters, its own cluster
            launches["ha"] = run_ha(WORK / "ha")
            mark("13")
            # phase 14: the filer and the S3 lifecycle, its own cluster
            launches["filer"] = run_filer(WORK / "filer")
            mark("14")
            # phase 15: the filer ring, its own cluster. What the earlier
            # phases left alive moves out of the collector's way for it:
            # filer A shares this process, and a full collection of a
            # large heap stalls its loop
            gc.collect()
            gc.freeze()
            try:
                launches["ring"] = run_ring(WORK / "ring")
            finally:
                gc.unfreeze()
            mark("15")
            # phase 16: the network stores, their own cluster
            gc.collect()
            gc.freeze()
            try:
                launches["nets"] = run_nets(WORK / "nets")
            finally:
                gc.unfreeze()
            mark("16")
            # phase 17: the S3 gateway, its own cluster
            gc.collect()
            gc.freeze()
            try:
                launches["s3"] = run_s3(WORK / "s3")
            finally:
                gc.unfreeze()
            mark("17")
            # phase 18: the filer's client surfaces, their own cluster
            gc.collect()
            gc.freeze()
            try:
                launches["dav"] = run_dav(WORK / "dav")
            finally:
                gc.unfreeze()
            mark("18")
            # phase 19: the cross-cluster planes, two clusters
            gc.collect()
            gc.freeze()
            try:
                launches["geo"] = run_geo(WORK / "geo")
            finally:
                gc.unfreeze()
            mark("19")
            # phase 20: the gRPC planes and the message broker, their
            # own cluster
            gc.collect()
            gc.freeze()
            try:
                launches["grpc"] = run_grpc(WORK / "grpc")
            finally:
                gc.unfreeze()
            mark("20")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # every governed step ran gf_apply and nothing else (TorchCoder has no
    # formulation hook, so the governor never switches its kernel); the
    # mxu entry ran the tensor-core kernel and nothing else
    for step, counts in launches["governed"].items():
        mine = "gf_apply_mxu" if step == "mxu_entry" else "gf_apply"
        if counts[mine] == 0 or any(n for name, n in counts.items()
                                    if name != mine):
            raise AssertionError(f"governed.{step}: launches {counts}, "
                                 f"want only {mine}")

    # main-path shapes: encode and rebuild batches are [10, 8 MiB] (the
    # feed joins consecutive 1 MiB small-block segments up to the batch
    # size); a degraded read is one interval, R = 1; the archive
    # collection's RS(20,4) at 8 MiB, and at the 4 MiB the governor plans
    # for k = 20 within its staging budget (the fused pass's batches)
    times = time_kernels(device, [("encode", 4, 10, 8 * MIB),
                                  ("rebuild", 4, 10, 8 * MIB),
                                  ("encode_1mib", 4, 10, MIB),
                                  ("degraded_read", 1, 10, 64 * 1024),
                                  ("archive", 4, 20, 8 * MIB),
                                  ("archive_4mib", 4, 20, 4 * MIB)])
    mark("5")
    log(smi)
    kernels = []
    main_steps = {**launches["bitplane"], **{
        f"xorsched.{k}": v for k, v in launches["xorsched"].items()}, **{
        f"governed.{k}": v for k, v in launches["governed"].items()
        if k != "mxu_entry"}, **launches["store"], **launches["fused"],
        **launches["cluster"], **{
        k: v for k, v in launches["lifecycle"].items()
        if k not in LIFECYCLE_CHECKS}, **launches["mesh"],
        **launches["balance"], **launches["storage"], **launches["ha"],
        **launches["filer"], **launches["ring"], **launches["nets"],
        **launches["s3"], **launches["dav"], **launches["geo"],
        **launches["grpc"]}
    for kernel in KERNELS:
        by_phase = {step: counts[kernel]
                    for step, counts in main_steps.items()}
        enc = times[kernel][0]
        row = {**KERNELS[kernel], "launches": sum(by_phase.values()),
               "launches_mesh": sum(counts[kernel] for step, counts in
                                    launches["mesh"].items()
                                    if step.startswith("mesh.")),
               "max_abs_err": checked["max_abs_err"][kernel],
               "ms": enc["ms"], "plain_ms": enc["plain_ms"],
               "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
               "library_ms": None, "shape": "[10,8MiB] -> [4,8MiB]",
               "host_us": enc["host_us"],
               "launches_by_phase": by_phase, "bit_equal": True,
               "library_note": "no single PyTorch call computes a GF(2^8) "
                               "matrix product"}
        for key in ("ops_per_column", "sass_per_16_columns", "mma_sync_ms",
                    "digest_ms", "digest_only_ms", "digest_library_ms"):
            if key in enc:
                row[key] = enc[key]
        for label, key, shape in [
                ("archive", "rs20_4", "[20,8MiB] -> [4,8MiB]"),
                ("archive_4mib", "rs20_4_4mib", "[20,4MiB] -> [4,4MiB]")]:
            arc = next(r for r in times[kernel] if r["shape"] == label)
            row[key] = {"shape": shape, **{k: arc[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "host_us")}}
        if kernel == "gf_apply_mxu":
            # no main-path step runs it (none does in the reference): its
            # launches are those of its own entry, the repack="mxu"
            # argument, over the volume's [10, 8 MiB] batches
            row["launches"] = launches["governed"]["mxu_entry"][kernel]
            row["launches_main_path"] = sum(by_phase.values())
            row["launches_entry"] = row["launches"]
        kernels.append(row)
    log({"kernels": kernels})
    # each phase's wall seconds, on the line before the last
    log({"phase": "phase_seconds", **phase_seconds,
         "total": time.perf_counter() - t0, "card": SMI[0]})
    log({"ok": True, "device": {"platform": "gpu", "kind": card,
                                "count": count}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)

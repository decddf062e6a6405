# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13volume_server.proto\x12\x14seaweedfs_tpu.volume\"\x07\n\x05\x45mpty\"@\n\tVolumeRef\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04\x66lag\x18\x03 \x01(\x08\"\x1f\n\x02Ok\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"J\n\x12\x42\x61tchDeleteRequest\x12\x0c\n\x04\x66ids\x18\x01 \x03(\t\x12\x19\n\x11skip_cookie_check\x18\x02 \x01(\x08\x12\x0b\n\x03jwt\x18\x03 \x01(\t\"H\n\x0c\x44\x65leteResult\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04size\x18\x04 \x01(\r\"J\n\x13\x42\x61tchDeleteResponse\x12\x33\n\x07results\x18\x01 \x03(\x0b\x32\".seaweedfs_tpu.volume.DeleteResult\";\n\x13NeedleStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\"t\n\x14NeedleStatusResponse\x12\x0e\n\x06\x63ookie\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\r\x12\x15\n\rlast_modified\x18\x03 \x01(\x04\x12\x0b\n\x03\x63rc\x18\x04 \x01(\r\x12\x0b\n\x03ttl\x18\x05 \x01(\t\x12\r\n\x05\x65rror\x18\x06 \x01(\t\";\n\x13VacuumCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"M\n\x14VacuumCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\"\n\x1a\x63ompaction_byte_per_second\x18\x02 \x01(\x03\"q\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\r\"@\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t\"z\n\x14VolumeStatusResponse\x12\x14\n\x0cis_read_only\x18\x01 \x01(\x08\x12\x13\n\x0bvolume_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x04 \x01(\x04\x12\r\n\x05\x65rror\x18\x05 \x01(\t\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"T\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x18\n\x10source_data_node\x18\x03 \x01(\t\"\x96\x01\n\x18VolumeSyncStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0btail_offset\x18\x03 \x01(\x04\x12\x18\n\x10\x63ompact_revision\x18\x04 \x01(\r\x12\x15\n\ridx_file_size\x18\x05 \x01(\x04\x12\r\n\x05\x65rror\x18\x06 \x01(\t\"\xaf\x01\n\x18VolumeFileStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x15\n\ridx_file_size\x18\x02 \x01(\x04\x12\x15\n\rdat_file_size\x18\x03 \x01(\x04\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x1b\n\x13\x63ompaction_revision\x18\x05 \x01(\r\x12\x12\n\ncollection\x18\x06 \x01(\t\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"p\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03\x65xt\x18\x03 \x01(\t\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12\x14\n\x0cis_ec_volume\x18\x05 \x01(\x08\"9\n\tDataChunk\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0f\n\x07is_last\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"P\n\x0bTailRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\"X\n\x13TailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14source_volume_server\x18\x03 \x01(\t\"\x90\x01\n\x11\x45\x63GenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x61ta_shards\x18\x03 \x01(\r\x12\x15\n\rparity_shards\x18\x04 \x01(\r\x12\x13\n\x0blarge_block\x18\x05 \x01(\r\x12\x13\n\x0bsmall_block\x18\x06 \x01(\r\"9\n\x10\x45\x63RebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"=\n\x11\x45\x63RebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"z\n\rEcCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\"K\n\x0f\x45\x63ShardsRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"W\n\x12\x45\x63ShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x04\x12\x0c\n\x04size\x18\x04 \x01(\x04\"_\n\x13\x45\x63\x42lobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"w\n\x0fTierMoveRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12 \n\x18\x64\x65stination_backend_name\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"B\n\nDiskStatus\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12\x0b\n\x03\x61ll\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x04 \x01(\x04\"\x94\x01\n\x1aVolumeServerStatusResponse\x12\x37\n\rdisk_statuses\x18\x01 \x03(\x0b\x32 .seaweedfs_tpu.volume.DiskStatus\x12\x14\n\x0cvolume_count\x18\x02 \x01(\r\x12\x16\n\x0e\x65\x63_shard_count\x18\x03 \x01(\r\x12\x0f\n\x07version\x18\x04 \x01(\t\"I\n\x0cQueryRequest\x12\x10\n\x08\x66ile_ids\x18\x01 \x03(\t\x12\x13\n\x0b\x66ilter_json\x18\x02 \x01(\t\x12\x12\n\nselections\x18\x03 \x03(\t2\x86\x1a\n\x0cVolumeServer\x12\x62\n\x0b\x42\x61tchDelete\x12(.seaweedfs_tpu.volume.BatchDeleteRequest\x1a).seaweedfs_tpu.volume.BatchDeleteResponse\x12k\n\x12VolumeNeedleStatus\x12).seaweedfs_tpu.volume.NeedleStatusRequest\x1a*.seaweedfs_tpu.volume.NeedleStatusResponse\x12_\n\x11VacuumVolumeCheck\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a).seaweedfs_tpu.volume.VacuumCheckResponse\x12[\n\x13VacuumVolumeCompact\x12*.seaweedfs_tpu.volume.VacuumCompactRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12O\n\x12VacuumVolumeCommit\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12P\n\x13VacuumVolumeCleanup\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12W\n\x0e\x41llocateVolume\x12+.seaweedfs_tpu.volume.AllocateVolumeRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12H\n\x0bVolumeMount\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12J\n\rVolumeUnmount\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12I\n\x0cVolumeDelete\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12O\n\x12VolumeMarkReadonly\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12O\n\x12VolumeMarkWritable\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12Y\n\x0fVolumeConfigure\x12,.seaweedfs_tpu.volume.VolumeConfigureRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12[\n\x0cVolumeStatus\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a*.seaweedfs_tpu.volume.VolumeStatusResponse\x12[\n\x10\x44\x65leteCollection\x12-.seaweedfs_tpu.volume.DeleteCollectionRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12O\n\nVolumeCopy\x12\'.seaweedfs_tpu.volume.VolumeCopyRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12g\n\x14ReadVolumeFileStatus\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a..seaweedfs_tpu.volume.VolumeFileStatusResponse\x12T\n\x08\x43opyFile\x12%.seaweedfs_tpu.volume.CopyFileRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x12R\n\nVolumeTail\x12!.seaweedfs_tpu.volume.TailRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x12X\n\x10VolumeTailSender\x12!.seaweedfs_tpu.volume.TailRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x12Y\n\x12VolumeTailReceiver\x12).seaweedfs_tpu.volume.TailReceiverRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12\x63\n\x10VolumeSyncStatus\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a..seaweedfs_tpu.volume.VolumeSyncStatusResponse\x12]\n\x15VolumeIncrementalCopy\x12!.seaweedfs_tpu.volume.TailRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x12[\n\x16VolumeEcShardsGenerate\x12\'.seaweedfs_tpu.volume.EcGenerateRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12h\n\x15VolumeEcShardsRebuild\x12&.seaweedfs_tpu.volume.EcRebuildRequest\x1a\'.seaweedfs_tpu.volume.EcRebuildResponse\x12S\n\x12VolumeEcShardsCopy\x12#.seaweedfs_tpu.volume.EcCopyRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12W\n\x14VolumeEcShardsDelete\x12%.seaweedfs_tpu.volume.EcShardsRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12V\n\x13VolumeEcShardsMount\x12%.seaweedfs_tpu.volume.EcShardsRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12X\n\x15VolumeEcShardsUnmount\x12%.seaweedfs_tpu.volume.EcShardsRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12`\n\x11VolumeEcShardRead\x12(.seaweedfs_tpu.volume.EcShardReadRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x12Y\n\x12VolumeEcBlobDelete\x12).seaweedfs_tpu.volume.EcBlobDeleteRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12S\n\x16VolumeEcShardsToVolume\x12\x1f.seaweedfs_tpu.volume.VolumeRef\x1a\x18.seaweedfs_tpu.volume.Ok\x12\\\n\x19VolumeTierMoveDatToRemote\x12%.seaweedfs_tpu.volume.TierMoveRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12^\n\x1bVolumeTierMoveDatFromRemote\x12%.seaweedfs_tpu.volume.TierMoveRequest\x1a\x18.seaweedfs_tpu.volume.Ok\x12\x63\n\x12VolumeServerStatus\x12\x1b.seaweedfs_tpu.volume.Empty\x1a\x30.seaweedfs_tpu.volume.VolumeServerStatusResponse\x12J\n\x11VolumeServerLeave\x12\x1b.seaweedfs_tpu.volume.Empty\x1a\x18.seaweedfs_tpu.volume.Ok\x12N\n\x05Query\x12\".seaweedfs_tpu.volume.QueryRequest\x1a\x1f.seaweedfs_tpu.volume.DataChunk0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=45
  _EMPTY._serialized_end=52
  _VOLUMEREF._serialized_start=54
  _VOLUMEREF._serialized_end=118
  _OK._serialized_start=120
  _OK._serialized_end=151
  _BATCHDELETEREQUEST._serialized_start=153
  _BATCHDELETEREQUEST._serialized_end=227
  _DELETERESULT._serialized_start=229
  _DELETERESULT._serialized_end=301
  _BATCHDELETERESPONSE._serialized_start=303
  _BATCHDELETERESPONSE._serialized_end=377
  _NEEDLESTATUSREQUEST._serialized_start=379
  _NEEDLESTATUSREQUEST._serialized_end=438
  _NEEDLESTATUSRESPONSE._serialized_start=440
  _NEEDLESTATUSRESPONSE._serialized_end=556
  _VACUUMCHECKRESPONSE._serialized_start=558
  _VACUUMCHECKRESPONSE._serialized_end=617
  _VACUUMCOMPACTREQUEST._serialized_start=619
  _VACUUMCOMPACTREQUEST._serialized_end=696
  _ALLOCATEVOLUMEREQUEST._serialized_start=698
  _ALLOCATEVOLUMEREQUEST._serialized_end=811
  _VOLUMECONFIGUREREQUEST._serialized_start=813
  _VOLUMECONFIGUREREQUEST._serialized_end=877
  _VOLUMESTATUSRESPONSE._serialized_start=879
  _VOLUMESTATUSRESPONSE._serialized_end=1001
  _DELETECOLLECTIONREQUEST._serialized_start=1003
  _DELETECOLLECTIONREQUEST._serialized_end=1048
  _VOLUMECOPYREQUEST._serialized_start=1050
  _VOLUMECOPYREQUEST._serialized_end=1134
  _VOLUMESYNCSTATUSRESPONSE._serialized_start=1137
  _VOLUMESYNCSTATUSRESPONSE._serialized_end=1287
  _VOLUMEFILESTATUSRESPONSE._serialized_start=1290
  _VOLUMEFILESTATUSRESPONSE._serialized_end=1465
  _COPYFILEREQUEST._serialized_start=1467
  _COPYFILEREQUEST._serialized_end=1579
  _DATACHUNK._serialized_start=1581
  _DATACHUNK._serialized_end=1638
  _TAILREQUEST._serialized_start=1640
  _TAILREQUEST._serialized_end=1720
  _TAILRECEIVERREQUEST._serialized_start=1722
  _TAILRECEIVERREQUEST._serialized_end=1810
  _ECGENERATEREQUEST._serialized_start=1813
  _ECGENERATEREQUEST._serialized_end=1957
  _ECREBUILDREQUEST._serialized_start=1959
  _ECREBUILDREQUEST._serialized_end=2016
  _ECREBUILDRESPONSE._serialized_start=2018
  _ECREBUILDRESPONSE._serialized_end=2079
  _ECCOPYREQUEST._serialized_start=2081
  _ECCOPYREQUEST._serialized_end=2203
  _ECSHARDSREQUEST._serialized_start=2205
  _ECSHARDSREQUEST._serialized_end=2280
  _ECSHARDREADREQUEST._serialized_start=2282
  _ECSHARDREADREQUEST._serialized_end=2369
  _ECBLOBDELETEREQUEST._serialized_start=2371
  _ECBLOBDELETEREQUEST._serialized_end=2466
  _TIERMOVEREQUEST._serialized_start=2468
  _TIERMOVEREQUEST._serialized_end=2587
  _DISKSTATUS._serialized_start=2589
  _DISKSTATUS._serialized_end=2655
  _VOLUMESERVERSTATUSRESPONSE._serialized_start=2658
  _VOLUMESERVERSTATUSRESPONSE._serialized_end=2806
  _QUERYREQUEST._serialized_start=2808
  _QUERYREQUEST._serialized_end=2881
  _VOLUMESERVER._serialized_start=2884
  _VOLUMESERVER._serialized_end=6218
# @@protoc_insertion_point(module_scope)

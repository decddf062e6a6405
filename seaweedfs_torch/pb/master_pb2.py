# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\x14seaweedfs_tpu.master\"\x13\n\x11VolumeListRequest\"\xe2\x01\n\x0bNodeVolumes\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x03 \x01(\t\x12\x0c\n\x04rack\x18\x04 \x01(\t\x12\x18\n\x10max_volume_count\x18\x05 \x01(\r\x12\x38\n\x07volumes\x18\x06 \x03(\x0b\x32\'.seaweedfs_tpu.master.VolumeInformation\x12;\n\tec_shards\x18\x07 \x03(\x0b\x32(.seaweedfs_tpu.master.EcShardInformation\"d\n\x12VolumeListResponse\x12\x30\n\x05nodes\x18\x01 \x03(\x0b\x32!.seaweedfs_tpu.master.NodeVolumes\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04\"I\n\x11StatisticsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"S\n\x15\x43ollectionListRequest\x12\x1e\n\x16include_normal_volumes\x18\x01 \x01(\x08\x12\x1a\n\x12include_ec_volumes\x18\x02 \x01(\x08\"-\n\x16\x43ollectionListResponse\x12\x13\n\x0b\x63ollections\x18\x01 \x03(\t\"\'\n\x17\x43ollectionDeleteRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"5\n\x18\x43ollectionDeleteResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x1f\n\x1dGetMasterConfigurationRequest\"\xb1\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x02 \x01(\r\x12\x1b\n\x13\x64\x65\x66\x61ult_replication\x18\x03 \x01(\t\x12\x1c\n\x14volume_size_limit_mb\x18\x04 \x01(\x04\x12\x19\n\x11garbage_threshold\x18\x05 \x01(\x02\"i\n\rAssignRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\"|\n\x0e\x41ssignResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\r\x12\x0c\n\x04\x61uth\x18\x05 \x01(\t\x12\x10\n\x08replicas\x18\x06 \x03(\t\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"G\n\rLookupRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0f\n\x07\x66ile_id\x18\x03 \x01(\t\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\"\x7f\n\x0eLookupResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x31\n\tlocations\x18\x02 \x03(\x0b\x32\x1e.seaweedfs_tpu.master.Location\x12\x0c\n\x04\x61uth\x18\x03 \x01(\t\x12\n\n\x02\x65\x63\x18\x04 \x01(\x08\x12\r\n\x05\x65rror\x18\x05 \x01(\t\"$\n\x0fLookupEcRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"W\n\x10\x45\x63ShardLocations\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x31\n\tlocations\x18\x02 \x03(\x0b\x32\x1e.seaweedfs_tpu.master.Location\"l\n\x10LookupEcResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x36\n\x06shards\x18\x02 \x03(\x0b\x32&.seaweedfs_tpu.master.EcShardLocations\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"\xce\x01\n\x11VolumeInformation\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0c\x64\x65lete_count\x18\x05 \x01(\x04\x12\x15\n\rdeleted_bytes\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\t\x12\x0b\n\x03ttl\x18\t \x01(\t\x12\x0f\n\x07version\x18\n \x01(\r\"_\n\x12\x45\x63ShardInformation\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r\x12\x12\n\nshard_size\x18\x04 \x01(\x04\"\x8e\x02\n\x10HeartbeatRequest\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\x12\x0c\n\x04rack\x18\x05 \x01(\t\x12\x18\n\x10max_volume_count\x18\x06 \x01(\r\x12\x14\n\x0cmax_file_key\x18\x07 \x01(\x04\x12\x38\n\x07volumes\x18\x08 \x03(\x0b\x32\'.seaweedfs_tpu.master.VolumeInformation\x12;\n\tec_shards\x18\t \x03(\x0b\x32(.seaweedfs_tpu.master.EcShardInformation\">\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\"+\n\x14KeepConnectedRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\"\x85\x01\n\x15VolumeLocationMessage\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x10\n\x08new_vids\x18\x03 \x03(\r\x12\x14\n\x0c\x64\x65leted_vids\x18\x04 \x03(\r\x12\x0e\n\x06leader\x18\x05 \x01(\t\x12\x13\n\x0bis_snapshot\x18\x06 \x01(\x08\"\x16\n\x14\x43lusterStatusRequest\"\\\n\x15\x43lusterStatusResponse\x12\x11\n\tis_leader\x18\x01 \x01(\x08\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\r\n\x05peers\x18\x03 \x03(\t\x12\x11\n\traft_term\x18\x04 \x01(\x04\"N\n\x16LeaseAdminTokenRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06\x63lient\x18\x02 \x01(\t\x12\x16\n\x0eprevious_token\x18\x03 \x01(\x03\"K\n\x17LeaseAdminTokenResponse\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x12\n\nexpires_at\x18\x02 \x01(\x01\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"7\n\x18ReleaseAdminTokenRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05token\x18\x02 \x01(\x03\"\'\n\x19ReleaseAdminTokenResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x32\xd3\n\n\x06Master\x12S\n\x06\x41ssign\x12#.seaweedfs_tpu.master.AssignRequest\x1a$.seaweedfs_tpu.master.AssignResponse\x12S\n\x06Lookup\x12#.seaweedfs_tpu.master.LookupRequest\x1a$.seaweedfs_tpu.master.LookupResponse\x12Y\n\x08LookupEc\x12%.seaweedfs_tpu.master.LookupEcRequest\x1a&.seaweedfs_tpu.master.LookupEcResponse\x12`\n\tHeartbeat\x12&.seaweedfs_tpu.master.HeartbeatRequest\x1a\'.seaweedfs_tpu.master.HeartbeatResponse(\x01\x30\x01\x12j\n\rKeepConnected\x12*.seaweedfs_tpu.master.KeepConnectedRequest\x1a+.seaweedfs_tpu.master.VolumeLocationMessage0\x01\x12h\n\rClusterStatus\x12*.seaweedfs_tpu.master.ClusterStatusRequest\x1a+.seaweedfs_tpu.master.ClusterStatusResponse\x12n\n\x0fLeaseAdminToken\x12,.seaweedfs_tpu.master.LeaseAdminTokenRequest\x1a-.seaweedfs_tpu.master.LeaseAdminTokenResponse\x12t\n\x11ReleaseAdminToken\x12..seaweedfs_tpu.master.ReleaseAdminTokenRequest\x1a/.seaweedfs_tpu.master.ReleaseAdminTokenResponse\x12_\n\nVolumeList\x12\'.seaweedfs_tpu.master.VolumeListRequest\x1a(.seaweedfs_tpu.master.VolumeListResponse\x12_\n\nStatistics\x12\'.seaweedfs_tpu.master.StatisticsRequest\x1a(.seaweedfs_tpu.master.StatisticsResponse\x12k\n\x0e\x43ollectionList\x12+.seaweedfs_tpu.master.CollectionListRequest\x1a,.seaweedfs_tpu.master.CollectionListResponse\x12q\n\x10\x43ollectionDelete\x12-.seaweedfs_tpu.master.CollectionDeleteRequest\x1a..seaweedfs_tpu.master.CollectionDeleteResponse\x12\x83\x01\n\x16GetMasterConfiguration\x12\x33.seaweedfs_tpu.master.GetMasterConfigurationRequest\x1a\x34.seaweedfs_tpu.master.GetMasterConfigurationResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VOLUMELISTREQUEST._serialized_start=38
  _VOLUMELISTREQUEST._serialized_end=57
  _NODEVOLUMES._serialized_start=60
  _NODEVOLUMES._serialized_end=286
  _VOLUMELISTRESPONSE._serialized_start=288
  _VOLUMELISTRESPONSE._serialized_end=388
  _STATISTICSREQUEST._serialized_start=390
  _STATISTICSREQUEST._serialized_end=463
  _STATISTICSRESPONSE._serialized_start=465
  _STATISTICSRESPONSE._serialized_end=544
  _COLLECTIONLISTREQUEST._serialized_start=546
  _COLLECTIONLISTREQUEST._serialized_end=629
  _COLLECTIONLISTRESPONSE._serialized_start=631
  _COLLECTIONLISTRESPONSE._serialized_end=676
  _COLLECTIONDELETEREQUEST._serialized_start=678
  _COLLECTIONDELETEREQUEST._serialized_end=717
  _COLLECTIONDELETERESPONSE._serialized_start=719
  _COLLECTIONDELETERESPONSE._serialized_end=772
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=774
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=805
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=808
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=985
  _ASSIGNREQUEST._serialized_start=987
  _ASSIGNREQUEST._serialized_end=1092
  _ASSIGNRESPONSE._serialized_start=1094
  _ASSIGNRESPONSE._serialized_end=1218
  _LOOKUPREQUEST._serialized_start=1220
  _LOOKUPREQUEST._serialized_end=1291
  _LOCATION._serialized_start=1293
  _LOCATION._serialized_end=1336
  _LOOKUPRESPONSE._serialized_start=1338
  _LOOKUPRESPONSE._serialized_end=1465
  _LOOKUPECREQUEST._serialized_start=1467
  _LOOKUPECREQUEST._serialized_end=1503
  _ECSHARDLOCATIONS._serialized_start=1505
  _ECSHARDLOCATIONS._serialized_end=1592
  _LOOKUPECRESPONSE._serialized_start=1594
  _LOOKUPECRESPONSE._serialized_end=1702
  _VOLUMEINFORMATION._serialized_start=1705
  _VOLUMEINFORMATION._serialized_end=1911
  _ECSHARDINFORMATION._serialized_start=1913
  _ECSHARDINFORMATION._serialized_end=2008
  _HEARTBEATREQUEST._serialized_start=2011
  _HEARTBEATREQUEST._serialized_end=2281
  _HEARTBEATRESPONSE._serialized_start=2283
  _HEARTBEATRESPONSE._serialized_end=2345
  _KEEPCONNECTEDREQUEST._serialized_start=2347
  _KEEPCONNECTEDREQUEST._serialized_end=2390
  _VOLUMELOCATIONMESSAGE._serialized_start=2393
  _VOLUMELOCATIONMESSAGE._serialized_end=2526
  _CLUSTERSTATUSREQUEST._serialized_start=2528
  _CLUSTERSTATUSREQUEST._serialized_end=2550
  _CLUSTERSTATUSRESPONSE._serialized_start=2552
  _CLUSTERSTATUSRESPONSE._serialized_end=2644
  _LEASEADMINTOKENREQUEST._serialized_start=2646
  _LEASEADMINTOKENREQUEST._serialized_end=2724
  _LEASEADMINTOKENRESPONSE._serialized_start=2726
  _LEASEADMINTOKENRESPONSE._serialized_end=2801
  _RELEASEADMINTOKENREQUEST._serialized_start=2803
  _RELEASEADMINTOKENREQUEST._serialized_end=2858
  _RELEASEADMINTOKENRESPONSE._serialized_start=2860
  _RELEASEADMINTOKENRESPONSE._serialized_end=2899
  _MASTER._serialized_start=2902
  _MASTER._serialized_end=4265
# @@protoc_insertion_point(module_scope)

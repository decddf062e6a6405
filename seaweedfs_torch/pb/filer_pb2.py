# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x13seaweedfs_tpu.filer\"\x07\n\x05\x45mpty\"\x1f\n\x02Ok\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\xec\x01\n\x0e\x46useAttributes\x12\r\n\x05mtime\x18\x01 \x01(\x01\x12\x0e\n\x06\x63rtime\x18\x02 \x01(\x01\x12\x0c\n\x04mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0c\n\x04mime\x18\x06 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x07 \x01(\r\x12\x11\n\tuser_name\x18\x08 \x01(\t\x12\x13\n\x0bgroup_names\x18\t \x03(\t\x12\x16\n\x0esymlink_target\x18\n \x01(\t\x12\x0b\n\x03md5\x18\x0b \x01(\t\x12\x13\n\x0breplication\x18\x0c \x01(\t\x12\x12\n\ncollection\x18\r \x01(\t\"\x85\x01\n\tFileChunk\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x10\n\x08mtime_ns\x18\x04 \x01(\x04\x12\x0c\n\x04\x65tag\x18\x05 \x01(\t\x12\x19\n\x11is_chunk_manifest\x18\x06 \x01(\x08\x12\x12\n\ncipher_key\x18\x07 \x01(\t\"\xfb\x01\n\x05\x45ntry\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x31\n\x04\x61ttr\x18\x02 \x01(\x0b\x32#.seaweedfs_tpu.filer.FuseAttributes\x12.\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x1e.seaweedfs_tpu.filer.FileChunk\x12:\n\x08\x65xtended\x18\x04 \x03(\x0b\x32(.seaweedfs_tpu.filer.Entry.ExtendedEntry\x12\x14\n\x0chard_link_id\x18\x05 \x01(\t\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"5\n\x12LookupEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"I\n\rEntryResponse\x12)\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"]\n\x0c\x45ntryRequest\x12)\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12\x0e\n\x06o_excl\x18\x02 \x01(\x08\x12\x12\n\nsignatures\x18\x03 \x03(\x05\"T\n\x14\x41ppendToEntryRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12.\n\x06\x63hunks\x18\x02 \x03(\x0b\x32\x1e.seaweedfs_tpu.filer.FileChunk\"p\n\x12\x44\x65leteEntryRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x14\n\x0cis_recursive\x18\x02 \x01(\x08\x12\x16\n\x0eis_delete_data\x18\x03 \x01(\x08\x12\x1e\n\x16ignore_recursive_error\x18\x04 \x01(\x08\"8\n\x12RenameEntryRequest\x12\x10\n\x08old_path\x18\x01 \x01(\t\x12\x10\n\x08new_path\x18\x02 \x01(\t\"s\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\"p\n\x14\x41ssignVolumeResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\x0c\n\x04\x61uth\x18\x05 \x01(\t\x12\r\n\x05\x65rror\x18\x06 \x01(\t\"1\n\x13LookupVolumeRequest\x12\x1a\n\x12volume_or_file_ids\x18\x01 \x03(\t\"\'\n\tLocations\x12\x0c\n\x04urls\x18\x01 \x03(\t\x12\x0c\n\x04\x61uth\x18\x02 \x01(\t\"\xbf\x01\n\x14LookupVolumeResponse\x12R\n\rlocations_map\x18\x01 \x03(\x0b\x32;.seaweedfs_tpu.filer.LookupVolumeResponse.LocationsMapEntry\x1aS\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.seaweedfs_tpu.filer.Locations:\x02\x38\x01\"-\n\x16\x43ollectionListResponse\x12\x13\n\x0b\x63ollections\x18\x01 \x03(\t\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"I\n\x11StatisticsRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"\x9e\x01\n\x1a\x46ilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r\x12\x13\n\x0b\x64ir_buckets\x18\x05 \x01(\t\x12\x0e\n\x06\x63ipher\x18\x06 \x01(\x08\x12\x11\n\tsignature\x18\x07 \x01(\x05\"q\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x19\n\x11\x65xclude_signature\x18\x04 \x01(\x05\"\xce\x01\n\tMetaEvent\x12\x0c\n\x04tsns\x18\x01 \x01(\x03\x12\x11\n\tdirectory\x18\x02 \x01(\t\x12-\n\told_entry\x18\x03 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12-\n\tnew_entry\x18\x04 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12\x15\n\rdelete_chunks\x18\x05 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x06 \x01(\t\x12\x12\n\nsignatures\x18\x07 \x03(\x05\"J\n\x14KeepConnectedRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tgrpc_port\x18\x02 \x01(\r\x12\x11\n\tresources\x18\x03 \x03(\t\"&\n\x15KeepConnectedResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\'\n\x13LocateBrokerRequest\x12\x10\n\x08resource\x18\x01 \x01(\t\">\n\x0e\x42rokerResource\x12\x14\n\x0cgrpc_address\x18\x01 \x01(\t\x12\x16\n\x0eresource_count\x18\x02 \x01(\x05\"]\n\x14LocateBrokerResponse\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\x12\x36\n\tresources\x18\x02 \x03(\x0b\x32#.seaweedfs_tpu.filer.BrokerResource\"\'\n\tKvRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"*\n\nKvResponse\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\r\n\x05\x65rror\x18\x02 \x01(\t2\xd7\r\n\x0cSeaweedFiler\x12\x63\n\x14LookupDirectoryEntry\x12\'.seaweedfs_tpu.filer.LookupEntryRequest\x1a\".seaweedfs_tpu.filer.EntryResponse\x12\\\n\x0bListEntries\x12\'.seaweedfs_tpu.filer.ListEntriesRequest\x1a\".seaweedfs_tpu.filer.EntryResponse0\x01\x12I\n\x0b\x43reateEntry\x12!.seaweedfs_tpu.filer.EntryRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12I\n\x0bUpdateEntry\x12!.seaweedfs_tpu.filer.EntryRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12S\n\rAppendToEntry\x12).seaweedfs_tpu.filer.AppendToEntryRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12O\n\x0b\x44\x65leteEntry\x12\'.seaweedfs_tpu.filer.DeleteEntryRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12U\n\x11\x41tomicRenameEntry\x12\'.seaweedfs_tpu.filer.RenameEntryRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12\x63\n\x0c\x41ssignVolume\x12(.seaweedfs_tpu.filer.AssignVolumeRequest\x1a).seaweedfs_tpu.filer.AssignVolumeResponse\x12\x63\n\x0cLookupVolume\x12(.seaweedfs_tpu.filer.LookupVolumeRequest\x1a).seaweedfs_tpu.filer.LookupVolumeResponse\x12Y\n\x0e\x43ollectionList\x12\x1a.seaweedfs_tpu.filer.Empty\x1a+.seaweedfs_tpu.filer.CollectionListResponse\x12Y\n\x10\x44\x65leteCollection\x12,.seaweedfs_tpu.filer.DeleteCollectionRequest\x1a\x17.seaweedfs_tpu.filer.Ok\x12]\n\nStatistics\x12&.seaweedfs_tpu.filer.StatisticsRequest\x1a\'.seaweedfs_tpu.filer.StatisticsResponse\x12\x64\n\x15GetFilerConfiguration\x12\x1a.seaweedfs_tpu.filer.Empty\x1a/.seaweedfs_tpu.filer.FilerConfigurationResponse\x12\x64\n\x11SubscribeMetadata\x12-.seaweedfs_tpu.filer.SubscribeMetadataRequest\x1a\x1e.seaweedfs_tpu.filer.MetaEvent0\x01\x12i\n\x16SubscribeLocalMetadata\x12-.seaweedfs_tpu.filer.SubscribeMetadataRequest\x1a\x1e.seaweedfs_tpu.filer.MetaEvent0\x01\x12j\n\rKeepConnected\x12).seaweedfs_tpu.filer.KeepConnectedRequest\x1a*.seaweedfs_tpu.filer.KeepConnectedResponse(\x01\x30\x01\x12\x63\n\x0cLocateBroker\x12(.seaweedfs_tpu.filer.LocateBrokerRequest\x1a).seaweedfs_tpu.filer.LocateBrokerResponse\x12H\n\x05KvGet\x12\x1e.seaweedfs_tpu.filer.KvRequest\x1a\x1f.seaweedfs_tpu.filer.KvResponse\x12@\n\x05KvPut\x12\x1e.seaweedfs_tpu.filer.KvRequest\x1a\x17.seaweedfs_tpu.filer.Okb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=36
  _EMPTY._serialized_end=43
  _OK._serialized_start=45
  _OK._serialized_end=76
  _FUSEATTRIBUTES._serialized_start=79
  _FUSEATTRIBUTES._serialized_end=315
  _FILECHUNK._serialized_start=318
  _FILECHUNK._serialized_end=451
  _ENTRY._serialized_start=454
  _ENTRY._serialized_end=705
  _ENTRY_EXTENDEDENTRY._serialized_start=658
  _ENTRY_EXTENDEDENTRY._serialized_end=705
  _LOOKUPENTRYREQUEST._serialized_start=707
  _LOOKUPENTRYREQUEST._serialized_end=760
  _ENTRYRESPONSE._serialized_start=762
  _ENTRYRESPONSE._serialized_end=835
  _LISTENTRIESREQUEST._serialized_start=838
  _LISTENTRIESREQUEST._serialized_end=968
  _ENTRYREQUEST._serialized_start=970
  _ENTRYREQUEST._serialized_end=1063
  _APPENDTOENTRYREQUEST._serialized_start=1065
  _APPENDTOENTRYREQUEST._serialized_end=1149
  _DELETEENTRYREQUEST._serialized_start=1151
  _DELETEENTRYREQUEST._serialized_end=1263
  _RENAMEENTRYREQUEST._serialized_start=1265
  _RENAMEENTRYREQUEST._serialized_end=1321
  _ASSIGNVOLUMEREQUEST._serialized_start=1323
  _ASSIGNVOLUMEREQUEST._serialized_end=1438
  _ASSIGNVOLUMERESPONSE._serialized_start=1440
  _ASSIGNVOLUMERESPONSE._serialized_end=1552
  _LOOKUPVOLUMEREQUEST._serialized_start=1554
  _LOOKUPVOLUMEREQUEST._serialized_end=1603
  _LOCATIONS._serialized_start=1605
  _LOCATIONS._serialized_end=1644
  _LOOKUPVOLUMERESPONSE._serialized_start=1647
  _LOOKUPVOLUMERESPONSE._serialized_end=1838
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=1755
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=1838
  _COLLECTIONLISTRESPONSE._serialized_start=1840
  _COLLECTIONLISTRESPONSE._serialized_end=1885
  _DELETECOLLECTIONREQUEST._serialized_start=1887
  _DELETECOLLECTIONREQUEST._serialized_end=1932
  _STATISTICSREQUEST._serialized_start=1934
  _STATISTICSREQUEST._serialized_end=2007
  _STATISTICSRESPONSE._serialized_start=2009
  _STATISTICSRESPONSE._serialized_end=2088
  _FILERCONFIGURATIONRESPONSE._serialized_start=2091
  _FILERCONFIGURATIONRESPONSE._serialized_end=2249
  _SUBSCRIBEMETADATAREQUEST._serialized_start=2251
  _SUBSCRIBEMETADATAREQUEST._serialized_end=2364
  _METAEVENT._serialized_start=2367
  _METAEVENT._serialized_end=2573
  _KEEPCONNECTEDREQUEST._serialized_start=2575
  _KEEPCONNECTEDREQUEST._serialized_end=2649
  _KEEPCONNECTEDRESPONSE._serialized_start=2651
  _KEEPCONNECTEDRESPONSE._serialized_end=2689
  _LOCATEBROKERREQUEST._serialized_start=2691
  _LOCATEBROKERREQUEST._serialized_end=2730
  _BROKERRESOURCE._serialized_start=2732
  _BROKERRESOURCE._serialized_end=2794
  _LOCATEBROKERRESPONSE._serialized_start=2796
  _LOCATEBROKERRESPONSE._serialized_end=2889
  _KVREQUEST._serialized_start=2891
  _KVREQUEST._serialized_end=2930
  _KVRESPONSE._serialized_start=2932
  _KVRESPONSE._serialized_end=2974
  _SEAWEEDFILER._serialized_start=2977
  _SEAWEEDFILER._serialized_end=4728
# @@protoc_insertion_point(module_scope)

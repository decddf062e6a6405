# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: messaging.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fmessaging.proto\x12\x17seaweedfs_tpu.messaging\"\xac\x01\n\x07Message\x12\x15\n\revent_time_ns\x18\x01 \x01(\x03\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12>\n\x07headers\x18\x04 \x03(\x0b\x32-.seaweedfs_tpu.messaging.Message.HeadersEntry\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xf5\x02\n\x11SubscriberMessage\x12\x44\n\x04init\x18\x01 \x01(\x0b\x32\x36.seaweedfs_tpu.messaging.SubscriberMessage.InitMessage\x12\x10\n\x08is_close\x18\x03 \x01(\x08\x1a\x87\x02\n\x0bInitMessage\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\\\n\x0estart_position\x18\x04 \x01(\x0e\x32\x44.seaweedfs_tpu.messaging.SubscriberMessage.InitMessage.StartPosition\x12\x14\n\x0ctimestamp_ns\x18\x05 \x01(\x03\x12\x15\n\rsubscriber_id\x18\x06 \x01(\t\"8\n\rStartPosition\x12\n\n\x06LATEST\x10\x00\x12\x0c\n\x08\x45\x41RLIEST\x10\x01\x12\r\n\tTIMESTAMP\x10\x02\"T\n\rBrokerMessage\x12.\n\x04\x64\x61ta\x18\x01 \x01(\x0b\x32 .seaweedfs_tpu.messaging.Message\x12\x13\n\x0bredirect_to\x18\x02 \x01(\t\"\xda\x01\n\x0ePublishRequest\x12\x41\n\x04init\x18\x01 \x01(\x0b\x32\x33.seaweedfs_tpu.messaging.PublishRequest.InitMessage\x12.\n\x04\x64\x61ta\x18\x02 \x01(\x0b\x32 .seaweedfs_tpu.messaging.Message\x1aU\n\x0bInitMessage\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\x12\x11\n\tack_level\x18\x04 \x01(\t\"H\n\x0fPublishResponse\x12\x11\n\tack_ts_ns\x18\x01 \x01(\x03\x12\x13\n\x0bredirect_to\x18\x02 \x01(\t\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"6\n\x12\x44\x65leteTopicRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"0\n\x13\x44\x65leteTopicResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"-\n\x12TopicConfiguration\x12\x17\n\x0fpartition_count\x18\x01 \x01(\x05\"}\n\x15\x43onfigureTopicRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x42\n\rconfiguration\x18\x03 \x01(\x0b\x32+.seaweedfs_tpu.messaging.TopicConfiguration\"3\n\x16\x43onfigureTopicResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"@\n\x1cGetTopicConfigurationRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\"c\n\x1dGetTopicConfigurationResponse\x12\x42\n\rconfiguration\x18\x01 \x01(\x0b\x32+.seaweedfs_tpu.messaging.TopicConfiguration\"H\n\x11\x46indBrokerRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\r\n\x05topic\x18\x02 \x01(\t\x12\x11\n\tpartition\x18\x03 \x01(\x05\"9\n\x12\x46indBrokerResponse\x12\x0e\n\x06\x62roker\x18\x01 \x01(\t\x12\x13\n\x0b\x61ll_brokers\x18\x02 \x03(\t2\xa6\x05\n\x10SeaweedMessaging\x12\x63\n\tSubscribe\x12*.seaweedfs_tpu.messaging.SubscriberMessage\x1a&.seaweedfs_tpu.messaging.BrokerMessage(\x01\x30\x01\x12`\n\x07Publish\x12\'.seaweedfs_tpu.messaging.PublishRequest\x1a(.seaweedfs_tpu.messaging.PublishResponse(\x01\x30\x01\x12h\n\x0b\x44\x65leteTopic\x12+.seaweedfs_tpu.messaging.DeleteTopicRequest\x1a,.seaweedfs_tpu.messaging.DeleteTopicResponse\x12q\n\x0e\x43onfigureTopic\x12..seaweedfs_tpu.messaging.ConfigureTopicRequest\x1a/.seaweedfs_tpu.messaging.ConfigureTopicResponse\x12\x86\x01\n\x15GetTopicConfiguration\x12\x35.seaweedfs_tpu.messaging.GetTopicConfigurationRequest\x1a\x36.seaweedfs_tpu.messaging.GetTopicConfigurationResponse\x12\x65\n\nFindBroker\x12*.seaweedfs_tpu.messaging.FindBrokerRequest\x1a+.seaweedfs_tpu.messaging.FindBrokerResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'messaging_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MESSAGE_HEADERSENTRY._options = None
  _MESSAGE_HEADERSENTRY._serialized_options = b'8\001'
  _MESSAGE._serialized_start=45
  _MESSAGE._serialized_end=217
  _MESSAGE_HEADERSENTRY._serialized_start=171
  _MESSAGE_HEADERSENTRY._serialized_end=217
  _SUBSCRIBERMESSAGE._serialized_start=220
  _SUBSCRIBERMESSAGE._serialized_end=593
  _SUBSCRIBERMESSAGE_INITMESSAGE._serialized_start=330
  _SUBSCRIBERMESSAGE_INITMESSAGE._serialized_end=593
  _SUBSCRIBERMESSAGE_INITMESSAGE_STARTPOSITION._serialized_start=537
  _SUBSCRIBERMESSAGE_INITMESSAGE_STARTPOSITION._serialized_end=593
  _BROKERMESSAGE._serialized_start=595
  _BROKERMESSAGE._serialized_end=679
  _PUBLISHREQUEST._serialized_start=682
  _PUBLISHREQUEST._serialized_end=900
  _PUBLISHREQUEST_INITMESSAGE._serialized_start=815
  _PUBLISHREQUEST_INITMESSAGE._serialized_end=900
  _PUBLISHRESPONSE._serialized_start=902
  _PUBLISHRESPONSE._serialized_end=974
  _DELETETOPICREQUEST._serialized_start=976
  _DELETETOPICREQUEST._serialized_end=1030
  _DELETETOPICRESPONSE._serialized_start=1032
  _DELETETOPICRESPONSE._serialized_end=1080
  _TOPICCONFIGURATION._serialized_start=1082
  _TOPICCONFIGURATION._serialized_end=1127
  _CONFIGURETOPICREQUEST._serialized_start=1129
  _CONFIGURETOPICREQUEST._serialized_end=1254
  _CONFIGURETOPICRESPONSE._serialized_start=1256
  _CONFIGURETOPICRESPONSE._serialized_end=1307
  _GETTOPICCONFIGURATIONREQUEST._serialized_start=1309
  _GETTOPICCONFIGURATIONREQUEST._serialized_end=1373
  _GETTOPICCONFIGURATIONRESPONSE._serialized_start=1375
  _GETTOPICCONFIGURATIONRESPONSE._serialized_end=1474
  _FINDBROKERREQUEST._serialized_start=1476
  _FINDBROKERREQUEST._serialized_end=1548
  _FINDBROKERRESPONSE._serialized_start=1550
  _FINDBROKERRESPONSE._serialized_end=1607
  _SEAWEEDMESSAGING._serialized_start=1610
  _SEAWEEDMESSAGING._serialized_end=2288
# @@protoc_insertion_point(module_scope)

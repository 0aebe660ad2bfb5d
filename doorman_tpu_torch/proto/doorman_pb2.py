# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: doorman.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rdoorman.proto\x12\x0b\x64oorman_tpu\"H\n\x05Lease\x12\x13\n\x0b\x65xpiry_time\x18\x01 \x01(\x03\x12\x18\n\x10refresh_interval\x18\x02 \x01(\x03\x12\x10\n\x08\x63\x61pacity\x18\x03 \x01(\x01\"u\n\x0fResourceRequest\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12\x10\n\x08priority\x18\x02 \x01(\x03\x12$\n\x03has\x18\x03 \x01(\x0b\x32\x12.doorman_tpu.LeaseH\x00\x88\x01\x01\x12\r\n\x05wants\x18\x04 \x01(\x01\x42\x06\n\x04_has\"W\n\x12GetCapacityRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12.\n\x08resource\x18\x02 \x03(\x0b\x32\x1c.doorman_tpu.ResourceRequest\"w\n\x10ResourceResponse\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12 \n\x04gets\x18\x02 \x01(\x0b\x32\x12.doorman_tpu.Lease\x12\x1a\n\rsafe_capacity\x18\x03 \x01(\x01H\x00\x88\x01\x01\x42\x10\n\x0e_safe_capacity\"<\n\nMastership\x12\x1b\n\x0emaster_address\x18\x01 \x01(\tH\x00\x88\x01\x01\x42\x11\n\x0f_master_address\"\x87\x01\n\x13GetCapacityResponse\x12/\n\x08response\x18\x01 \x03(\x0b\x32\x1d.doorman_tpu.ResourceResponse\x12\x30\n\nmastership\x18\x02 \x01(\x0b\x32\x17.doorman_tpu.MastershipH\x00\x88\x01\x01\x42\r\n\x0b_mastership\"M\n\x15PriorityBandAggregate\x12\x10\n\x08priority\x18\x01 \x01(\x03\x12\x13\n\x0bnum_clients\x18\x02 \x01(\x03\x12\r\n\x05wants\x18\x03 \x01(\x01\"\x95\x01\n\x1dServerCapacityResourceRequest\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12$\n\x03has\x18\x02 \x01(\x0b\x32\x12.doorman_tpu.LeaseH\x00\x88\x01\x01\x12\x31\n\x05wants\x18\x03 \x03(\x0b\x32\".doorman_tpu.PriorityBandAggregateB\x06\n\x04_has\"k\n\x18GetServerCapacityRequest\x12\x11\n\tserver_id\x18\x01 \x01(\t\x12<\n\x08resource\x18\x02 \x03(\x0b\x32*.doorman_tpu.ServerCapacityResourceRequest\"\xc3\x01\n\x1eServerCapacityResourceResponse\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12 \n\x04gets\x18\x02 \x01(\x0b\x32\x12.doorman_tpu.Lease\x12.\n\talgorithm\x18\x03 \x01(\x0b\x32\x16.doorman_tpu.AlgorithmH\x00\x88\x01\x01\x12\x1a\n\rsafe_capacity\x18\x04 \x01(\x01H\x01\x88\x01\x01\x42\x0c\n\n_algorithmB\x10\n\x0e_safe_capacity\"\x9b\x01\n\x19GetServerCapacityResponse\x12=\n\x08response\x18\x01 \x03(\x0b\x32+.doorman_tpu.ServerCapacityResourceResponse\x12\x30\n\nmastership\x18\x02 \x01(\x0b\x32\x17.doorman_tpu.MastershipH\x00\x88\x01\x01\x42\r\n\x0b_mastership\"@\n\x16ReleaseCapacityRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x13\n\x0bresource_id\x18\x02 \x03(\t\"Z\n\x17ReleaseCapacityResponse\x12\x30\n\nmastership\x18\x01 \x01(\x0b\x32\x17.doorman_tpu.MastershipH\x00\x88\x01\x01\x42\r\n\x0b_mastership\"<\n\x0eNamedParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\x05value\x18\x02 \x01(\tH\x00\x88\x01\x01\x42\x08\n\x06_value\"\xb9\x02\n\tAlgorithm\x12)\n\x04kind\x18\x01 \x01(\x0e\x32\x1b.doorman_tpu.Algorithm.Kind\x12\x14\n\x0clease_length\x18\x02 \x01(\x03\x12\x18\n\x10refresh_interval\x18\x03 \x01(\x03\x12/\n\nparameters\x18\x04 \x03(\x0b\x32\x1b.doorman_tpu.NamedParameter\x12#\n\x16learning_mode_duration\x18\x05 \x01(\x03H\x00\x88\x01\x01\"`\n\x04Kind\x12\x10\n\x0cNO_ALGORITHM\x10\x00\x12\n\n\x06STATIC\x10\x01\x12\x16\n\x12PROPORTIONAL_SHARE\x10\x02\x12\x0e\n\nFAIR_SHARE\x10\x03\x12\x12\n\x0ePRIORITY_BANDS\x10\x04\x42\x19\n\x17_learning_mode_duration\"\xf0\x01\n\x10ResourceTemplate\x12\x17\n\x0fidentifier_glob\x18\x01 \x01(\t\x12\x10\n\x08\x63\x61pacity\x18\x02 \x01(\x01\x12)\n\talgorithm\x18\x03 \x01(\x0b\x32\x16.doorman_tpu.Algorithm\x12\x1a\n\rsafe_capacity\x18\x04 \x01(\x01H\x00\x88\x01\x01\x12\x18\n\x0b\x64\x65scription\x18\x05 \x01(\tH\x01\x88\x01\x01\x12\x1b\n\x0e\x63\x61pacity_group\x18\x06 \x01(\tH\x02\x88\x01\x01\x42\x10\n\x0e_safe_capacityB\x0e\n\x0c_descriptionB\x11\n\x0f_capacity_group\"/\n\rCapacityGroup\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x63\x61pacity\x18\x02 \x01(\x01\"r\n\x12ResourceRepository\x12\x30\n\tresources\x18\x01 \x03(\x0b\x32\x1d.doorman_tpu.ResourceTemplate\x12*\n\x06groups\x18\x02 \x03(\x0b\x32\x1a.doorman_tpu.CapacityGroup\"\x12\n\x10\x44iscoveryRequest\"S\n\x11\x44iscoveryResponse\x12+\n\nmastership\x18\x01 \x01(\x0b\x32\x17.doorman_tpu.Mastership\x12\x11\n\tis_master\x18\x02 \x01(\x08\x32\xea\x02\n\x08\x43\x61pacity\x12J\n\tDiscovery\x12\x1d.doorman_tpu.DiscoveryRequest\x1a\x1e.doorman_tpu.DiscoveryResponse\x12P\n\x0bGetCapacity\x12\x1f.doorman_tpu.GetCapacityRequest\x1a .doorman_tpu.GetCapacityResponse\x12\x62\n\x11GetServerCapacity\x12%.doorman_tpu.GetServerCapacityRequest\x1a&.doorman_tpu.GetServerCapacityResponse\x12\\\n\x0fReleaseCapacity\x12#.doorman_tpu.ReleaseCapacityRequest\x1a$.doorman_tpu.ReleaseCapacityResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'doorman_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LEASE._serialized_start=30
  _LEASE._serialized_end=102
  _RESOURCEREQUEST._serialized_start=104
  _RESOURCEREQUEST._serialized_end=221
  _GETCAPACITYREQUEST._serialized_start=223
  _GETCAPACITYREQUEST._serialized_end=310
  _RESOURCERESPONSE._serialized_start=312
  _RESOURCERESPONSE._serialized_end=431
  _MASTERSHIP._serialized_start=433
  _MASTERSHIP._serialized_end=493
  _GETCAPACITYRESPONSE._serialized_start=496
  _GETCAPACITYRESPONSE._serialized_end=631
  _PRIORITYBANDAGGREGATE._serialized_start=633
  _PRIORITYBANDAGGREGATE._serialized_end=710
  _SERVERCAPACITYRESOURCEREQUEST._serialized_start=713
  _SERVERCAPACITYRESOURCEREQUEST._serialized_end=862
  _GETSERVERCAPACITYREQUEST._serialized_start=864
  _GETSERVERCAPACITYREQUEST._serialized_end=971
  _SERVERCAPACITYRESOURCERESPONSE._serialized_start=974
  _SERVERCAPACITYRESOURCERESPONSE._serialized_end=1169
  _GETSERVERCAPACITYRESPONSE._serialized_start=1172
  _GETSERVERCAPACITYRESPONSE._serialized_end=1327
  _RELEASECAPACITYREQUEST._serialized_start=1329
  _RELEASECAPACITYREQUEST._serialized_end=1393
  _RELEASECAPACITYRESPONSE._serialized_start=1395
  _RELEASECAPACITYRESPONSE._serialized_end=1485
  _NAMEDPARAMETER._serialized_start=1487
  _NAMEDPARAMETER._serialized_end=1547
  _ALGORITHM._serialized_start=1550
  _ALGORITHM._serialized_end=1863
  _ALGORITHM_KIND._serialized_start=1740
  _ALGORITHM_KIND._serialized_end=1836
  _RESOURCETEMPLATE._serialized_start=1866
  _RESOURCETEMPLATE._serialized_end=2106
  _CAPACITYGROUP._serialized_start=2108
  _CAPACITYGROUP._serialized_end=2155
  _RESOURCEREPOSITORY._serialized_start=2157
  _RESOURCEREPOSITORY._serialized_end=2271
  _DISCOVERYREQUEST._serialized_start=2273
  _DISCOVERYREQUEST._serialized_end=2291
  _DISCOVERYRESPONSE._serialized_start=2293
  _DISCOVERYRESPONSE._serialized_end=2376
  _CAPACITY._serialized_start=2379
  _CAPACITY._serialized_end=2741
# @@protoc_insertion_point(module_scope)

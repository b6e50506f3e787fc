# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: herdsman.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eherdsman.proto\x12\x08herdsman\"3\n\x13\x41uthenticationToken\x12\x1c\n\x14\x61uthentication_token\x18\x01 \x01(\t\" \n\x0f\x43onnectionToken\x12\r\n\x05token\x18\x01 \x01(\t\"\x07\n\x05\x45mpty\"$\n\x14SessionCreateRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\")\n\x0bSessionInfo\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"%\n\x15SessionDestroyRequest\x12\x0c\n\x04uuid\x18\x01 \x01(\t\":\n\x0fSessionInfoList\x12\'\n\x08sessions\x18\x01 \x03(\x0b\x32\x15.herdsman.SessionInfo\"H\n\x14SessionAddKeyOptions\x12\x0c\n\x04type\x18\x01 \x01(\r\x12\x14\n\x0csession_uuid\x18\x02 \x01(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04\"a\n\x14SessionAddKeyRequest\x12\x31\n\x07options\x18\x01 \x01(\x0b\x32\x1e.herdsman.SessionAddKeyOptionsH\x00\x12\x0e\n\x04\x64\x61ta\x18\x02 \x01(\x0cH\x00\x42\x06\n\x04part\"=\n\x17SessionRemoveKeyRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\r\"-\n\x15SessionKeyListRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\"\x1e\n\x0eSessionKeyList\x12\x0c\n\x04type\x18\x01 \x03(\r\"3\n\x10\x43olumnDescriptor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdata_type\x18\x02 \x01(\r\"\xba\x01\n\rDataFrameInfo\x12\x0c\n\x04type\x18\x01 \x01(\r\x12\x14\n\x0csession_uuid\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x11\n\trow_count\x18\x04 \x01(\x04\x12\x12\n\npartitions\x18\x05 \x01(\r\x12+\n\x07\x63olumns\x18\x06 \x03(\x0b\x32\x1a.herdsman.ColumnDescriptor\x12\x0e\n\x06seeded\x18\x07 \x01(\x08\x12\x13\n\x0bseeded_seed\x18\x08 \x01(\x04\"V\n\x13\x44\x61taFrameAddRequest\x12\'\n\x04info\x18\x01 \x01(\x0b\x32\x17.herdsman.DataFrameInfoH\x00\x12\x0e\n\x04\x64\x61ta\x18\x02 \x01(\x0cH\x00\x42\x06\n\x04part\"\x99\x01\n\x11\x44\x61taFrameMetadata\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x13\n\x0bschema_type\x18\x03 \x01(\r\x12+\n\x07\x63olumns\x18\x04 \x03(\x0b\x32\x1a.herdsman.ColumnDescriptor\x12\x12\n\nrows_count\x18\x05 \x01(\x04\x12\x12\n\npartitions\x18\x06 \x01(\r\"E\n\x14\x44\x61taFrameAddResponse\x12-\n\x08metadata\x18\x01 \x01(\x0b\x32\x1b.herdsman.DataFrameMetadata\"<\n\x16\x44\x61taFrameRemoveRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x0c\n\x04uuid\x18\x02 \x01(\t\"H\n\x14\x44\x61taFrameListRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x11\n\x04type\x18\x02 \x01(\rH\x00\x88\x01\x01\x42\x07\n\x05_type\"H\n\x15\x44\x61taFrameMetadataList\x12/\n\ndataframes\x18\x01 \x03(\x0b\x32\x1b.herdsman.DataFrameMetadata\">\n\x18\x44\x61taFrameDownloadRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x0c\n\x04uuid\x18\x02 \x01(\t\"1\n\x0e\x44\x61taFrameChunk\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x11\n\tpartition\x18\x02 \x01(\r\" \n\x04Gate\x12\n\n\x02op\x18\x01 \x01(\r\x12\x0c\n\x04\x61rgs\x18\x02 \x03(\r\">\n\x0cOutputColumn\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdata_type\x18\x02 \x01(\r\x12\r\n\x05wires\x18\x03 \x03(\r\"\x8b\x01\n\x07\x43ircuit\x12\x31\n\rinput_columns\x18\x01 \x03(\x0b\x32\x1a.herdsman.ColumnDescriptor\x12\x1d\n\x05gates\x18\x02 \x03(\x0b\x32\x0e.herdsman.Gate\x12.\n\x0eoutput_columns\x18\x03 \x03(\x0b\x32\x16.herdsman.OutputColumn\"*\n\x0fInputStageProto\x12\x17\n\x0f\x64\x61ta_frame_uuid\x18\x01 \x01(\t\" \n\x10OutputStageProto\x12\x0c\n\x04name\x18\x01 \x01(\t\"6\n\x10MapperStageProto\x12\"\n\x07\x63ircuit\x18\x01 \x01(\x0b\x32\x11.herdsman.Circuit\"v\n\x10ReduceStageProto\x12\"\n\x07\x63ircuit\x18\x01 \x01(\x0b\x32\x11.herdsman.Circuit\x12\x0e\n\x06policy\x18\x02 \x01(\r\x12\x1b\n\x0eper_node_count\x18\x03 \x01(\rH\x00\x88\x01\x01\x42\x11\n\x0f_per_node_count\"\xc3\x01\n\x05Stage\x12*\n\x05input\x18\x01 \x01(\x0b\x32\x19.herdsman.InputStageProtoH\x00\x12,\n\x06output\x18\x02 \x01(\x0b\x32\x1a.herdsman.OutputStageProtoH\x00\x12)\n\x03map\x18\x03 \x01(\x0b\x32\x1a.herdsman.MapperStageProtoH\x00\x12,\n\x06reduce\x18\x04 \x01(\x0b\x32\x1a.herdsman.ReduceStageProtoH\x00\x42\x07\n\x05stage\" \n\x04\x45\x64ge\x12\x0b\n\x03src\x18\x01 \x01(\r\x12\x0b\n\x03\x64st\x18\x02 \x01(\r\"i\n\x12\x45xecutionPlanProto\x12\x13\n\x0bschema_type\x18\x01 \x01(\r\x12\x1f\n\x06stages\x18\x02 \x03(\x0b\x32\x0f.herdsman.Stage\x12\x1d\n\x05\x65\x64ges\x18\x03 \x03(\x0b\x32\x0e.herdsman.Edge\"q\n\x12ScheduleJobRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12*\n\x04plan\x18\x02 \x01(\x0b\x32\x1c.herdsman.ExecutionPlanProto\x12\x19\n\x11\x63oncurrency_limit\x18\x03 \x01(\r\"h\n\x0eJobDescription\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12*\n\x04plan\x18\x02 \x01(\x0b\x32\x1c.herdsman.ExecutionPlanProto\x12\x1c\n\x14\x65stimated_complexity\x18\x03 \x01(\x04\"8\n\x12GetJobStateRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x0c\n\x04uuid\x18\x02 \x01(\t\"\x96\x01\n\x08JobState\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\r\x12\x14\n\x07message\x18\x03 \x01(\tH\x00\x88\x01\x01\x12\x16\n\x0etasks_executed\x18\x04 \x01(\x04\x12\x1b\n\x13\x62ootstraps_executed\x18\x05 \x01(\x04\x12\x15\n\routput_frames\x18\x06 \x03(\tB\n\n\x08_message\"\'\n\x0fListJobsRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\"2\n\x0cJobStateList\x12\"\n\x06states\x18\x01 \x03(\x0b\x32\x12.herdsman.JobState\"8\n\x12\x44\x65scribeJobRequest\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x0c\n\x04uuid\x18\x02 \x01(\t\"4\n\x11\x44\x61taFramePtrProto\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x11\n\tpartition\x18\x02 \x01(\r\"L\n\x16InputDataFramePtrProto\x12\x0c\n\x04uuid\x18\x01 \x01(\t\x12\x11\n\tpartition\x18\x02 \x01(\r\x12\x11\n\trow_count\x18\x03 \x01(\x04\"(\n\x11\x43ryptoKeyPtrProto\x12\x13\n\x0bschema_type\x18\x01 \x01(\r\"\xd0\x01\n\x0cMapTaskProto\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12/\n\x05input\x18\x02 \x01(\x0b\x32 .herdsman.InputDataFramePtrProto\x12+\n\x06output\x18\x03 \x01(\x0b\x32\x1b.herdsman.DataFramePtrProto\x12(\n\x03key\x18\x04 \x01(\x0b\x32\x1b.herdsman.CryptoKeyPtrProto\x12\"\n\x07\x63ircuit\x18\x05 \x01(\x0b\x32\x11.herdsman.Circuit\"\xd4\x01\n\x0fReduceTaskProto\x12\x14\n\x0csession_uuid\x18\x01 \x01(\t\x12\x30\n\x06inputs\x18\x02 \x03(\x0b\x32 .herdsman.InputDataFramePtrProto\x12+\n\x06output\x18\x03 \x01(\x0b\x32\x1b.herdsman.DataFramePtrProto\x12(\n\x03key\x18\x04 \x01(\x0b\x32\x1b.herdsman.CryptoKeyPtrProto\x12\"\n\x07\x63ircuit\x18\x05 \x01(\x0b\x32\x11.herdsman.Circuitb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'herdsman_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _AUTHENTICATIONTOKEN._serialized_start=28
  _AUTHENTICATIONTOKEN._serialized_end=79
  _CONNECTIONTOKEN._serialized_start=81
  _CONNECTIONTOKEN._serialized_end=113
  _EMPTY._serialized_start=115
  _EMPTY._serialized_end=122
  _SESSIONCREATEREQUEST._serialized_start=124
  _SESSIONCREATEREQUEST._serialized_end=160
  _SESSIONINFO._serialized_start=162
  _SESSIONINFO._serialized_end=203
  _SESSIONDESTROYREQUEST._serialized_start=205
  _SESSIONDESTROYREQUEST._serialized_end=242
  _SESSIONINFOLIST._serialized_start=244
  _SESSIONINFOLIST._serialized_end=302
  _SESSIONADDKEYOPTIONS._serialized_start=304
  _SESSIONADDKEYOPTIONS._serialized_end=376
  _SESSIONADDKEYREQUEST._serialized_start=378
  _SESSIONADDKEYREQUEST._serialized_end=475
  _SESSIONREMOVEKEYREQUEST._serialized_start=477
  _SESSIONREMOVEKEYREQUEST._serialized_end=538
  _SESSIONKEYLISTREQUEST._serialized_start=540
  _SESSIONKEYLISTREQUEST._serialized_end=585
  _SESSIONKEYLIST._serialized_start=587
  _SESSIONKEYLIST._serialized_end=617
  _COLUMNDESCRIPTOR._serialized_start=619
  _COLUMNDESCRIPTOR._serialized_end=670
  _DATAFRAMEINFO._serialized_start=673
  _DATAFRAMEINFO._serialized_end=859
  _DATAFRAMEADDREQUEST._serialized_start=861
  _DATAFRAMEADDREQUEST._serialized_end=947
  _DATAFRAMEMETADATA._serialized_start=950
  _DATAFRAMEMETADATA._serialized_end=1103
  _DATAFRAMEADDRESPONSE._serialized_start=1105
  _DATAFRAMEADDRESPONSE._serialized_end=1174
  _DATAFRAMEREMOVEREQUEST._serialized_start=1176
  _DATAFRAMEREMOVEREQUEST._serialized_end=1236
  _DATAFRAMELISTREQUEST._serialized_start=1238
  _DATAFRAMELISTREQUEST._serialized_end=1310
  _DATAFRAMEMETADATALIST._serialized_start=1312
  _DATAFRAMEMETADATALIST._serialized_end=1384
  _DATAFRAMEDOWNLOADREQUEST._serialized_start=1386
  _DATAFRAMEDOWNLOADREQUEST._serialized_end=1448
  _DATAFRAMECHUNK._serialized_start=1450
  _DATAFRAMECHUNK._serialized_end=1499
  _GATE._serialized_start=1501
  _GATE._serialized_end=1533
  _OUTPUTCOLUMN._serialized_start=1535
  _OUTPUTCOLUMN._serialized_end=1597
  _CIRCUIT._serialized_start=1600
  _CIRCUIT._serialized_end=1739
  _INPUTSTAGEPROTO._serialized_start=1741
  _INPUTSTAGEPROTO._serialized_end=1783
  _OUTPUTSTAGEPROTO._serialized_start=1785
  _OUTPUTSTAGEPROTO._serialized_end=1817
  _MAPPERSTAGEPROTO._serialized_start=1819
  _MAPPERSTAGEPROTO._serialized_end=1873
  _REDUCESTAGEPROTO._serialized_start=1875
  _REDUCESTAGEPROTO._serialized_end=1993
  _STAGE._serialized_start=1996
  _STAGE._serialized_end=2191
  _EDGE._serialized_start=2193
  _EDGE._serialized_end=2225
  _EXECUTIONPLANPROTO._serialized_start=2227
  _EXECUTIONPLANPROTO._serialized_end=2332
  _SCHEDULEJOBREQUEST._serialized_start=2334
  _SCHEDULEJOBREQUEST._serialized_end=2447
  _JOBDESCRIPTION._serialized_start=2449
  _JOBDESCRIPTION._serialized_end=2553
  _GETJOBSTATEREQUEST._serialized_start=2555
  _GETJOBSTATEREQUEST._serialized_end=2611
  _JOBSTATE._serialized_start=2614
  _JOBSTATE._serialized_end=2764
  _LISTJOBSREQUEST._serialized_start=2766
  _LISTJOBSREQUEST._serialized_end=2805
  _JOBSTATELIST._serialized_start=2807
  _JOBSTATELIST._serialized_end=2857
  _DESCRIBEJOBREQUEST._serialized_start=2859
  _DESCRIBEJOBREQUEST._serialized_end=2915
  _DATAFRAMEPTRPROTO._serialized_start=2917
  _DATAFRAMEPTRPROTO._serialized_end=2969
  _INPUTDATAFRAMEPTRPROTO._serialized_start=2971
  _INPUTDATAFRAMEPTRPROTO._serialized_end=3047
  _CRYPTOKEYPTRPROTO._serialized_start=3049
  _CRYPTOKEYPTRPROTO._serialized_end=3089
  _MAPTASKPROTO._serialized_start=3092
  _MAPTASKPROTO._serialized_end=3300
  _REDUCETASKPROTO._serialized_start=3303
  _REDUCETASKPROTO._serialized_end=3515
# @@protoc_insertion_point(module_scope)

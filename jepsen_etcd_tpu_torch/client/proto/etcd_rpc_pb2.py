# -*- coding: utf-8 -*-
# Generated by regen_pb2.py (protoc-compatible output; no protoc in
# this environment).  DO NOT EDIT BY HAND.
# source: etcd_rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0eetcd_rpc.proto\x12\x08etcdwire"u\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x17\n\x0fcreate_revision\x18\x02 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x03 \x01(\x03\x12\x0f\n\x07version\x18\x04 \x01(\x03\x12\r\n\x05value\x18\x05 \x01(\x0c\x12\r\n\x05lease\x18\x06 \x01(\x03"\x97\x01\n\x05Event\x12\'\n\x04type\x18\x01 \x01(\x0e2\x19.etcdwire.Event.EventType\x12\x1e\n\x02kv\x18\x02 \x01(\x0b2\x12.etcdwire.KeyValue\x12#\n\x07prev_kv\x18\x03 \x01(\x0b2\x12.etcdwire.KeyValue" \n\tEventType\x12\x07\n\x03PUT\x10\x00\x12\n\n\x06DELETE\x10\x01"\\\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x10\n\x08revision\x18\x03 \x01(\x03\x12\x11\n\traft_term\x18\x04 \x01(\x04"y\n\x0cRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x10\n\x08revision\x18\x04 \x01(\x03\x12\x14\n\x0cserializable\x18\x07 \x01(\x08\x12\x12\n\ncount_only\x18\t \x01(\x08"w\n\rRangeResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x1f\n\x03kvs\x18\x02 \x03(\x0b2\x12.etcdwire.KeyValue\x12\x0c\n\x04more\x18\x03 \x01(\x08\x12\r\n\x05count\x18\x04 \x01(\x03"H\n\nPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05lease\x18\x03 \x01(\x03\x12\x0f\n\x07prev_kv\x18\x04 \x01(\x08"\\\n\x0bPutResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12#\n\x07prev_kv\x18\x02 \x01(\x0b2\x12.etcdwire.KeyValue"E\n\x12DeleteRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x0f\n\x07prev_kv\x18\x03 \x01(\x08"v\n\x13DeleteRangeResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x0f\n\x07deleted\x18\x02 \x01(\x03\x12$\n\x08prev_kvs\x18\x03 \x03(\x0b2\x12.etcdwire.KeyValue"\xb2\x01\n\tRequestOp\x12/\n\rrequest_range\x18\x01 \x01(\x0b2\x16.etcdwire.RangeRequestH\x00\x12+\n\x0brequest_put\x18\x02 \x01(\x0b2\x14.etcdwire.PutRequestH\x00\x12<\n\x14request_delete_range\x18\x03 \x01(\x0b2\x1c.etcdwire.DeleteRangeRequestH\x00B\t\n\x07request"\xba\x01\n\nResponseOp\x121\n\x0eresponse_range\x18\x01 \x01(\x0b2\x17.etcdwire.RangeResponseH\x00\x12-\n\x0cresponse_put\x18\x02 \x01(\x0b2\x15.etcdwire.PutResponseH\x00\x12>\n\x15response_delete_range\x18\x03 \x01(\x0b2\x1d.etcdwire.DeleteRangeResponseH\x00B\n\n\x08response"\xfb\x02\n\x07Compare\x12/\n\x06result\x18\x01 \x01(\x0e2\x1f.etcdwire.Compare.CompareResult\x12/\n\x06target\x18\x02 \x01(\x0e2\x1f.etcdwire.Compare.CompareTarget\x12\x0b\n\x03key\x18\x03 \x01(\x0c\x12\x11\n\x07version\x18\x04 \x01(\x03H\x00\x12\x19\n\x0fcreate_revision\x18\x05 \x01(\x03H\x00\x12\x16\n\x0cmod_revision\x18\x06 \x01(\x03H\x00\x12\x0f\n\x05value\x18\x07 \x01(\x0cH\x00\x12\x0f\n\x05lease\x18\x08 \x01(\x03H\x00"@\n\rCompareResult\x12\t\n\x05EQUAL\x10\x00\x12\x0b\n\x07GREATER\x10\x01\x12\x08\n\x04LESS\x10\x02\x12\r\n\tNOT_EQUAL\x10\x03"G\n\rCompareTarget\x12\x0b\n\x07VERSION\x10\x00\x12\n\n\x06CREATE\x10\x01\x12\x07\n\x03MOD\x10\x02\x12\t\n\x05VALUE\x10\x03\x12\t\n\x05LEASE\x10\x04B\x0e\n\x0ctarget_union"|\n\nTxnRequest\x12"\n\x07compare\x18\x01 \x03(\x0b2\x11.etcdwire.Compare\x12$\n\x07success\x18\x02 \x03(\x0b2\x13.etcdwire.RequestOp\x12$\n\x07failure\x18\x03 \x03(\x0b2\x13.etcdwire.RequestOp"s\n\x0bTxnResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x11\n\tsucceeded\x18\x02 \x01(\x08\x12\'\n\tresponses\x18\x03 \x03(\x0b2\x14.etcdwire.ResponseOp"7\n\x11CompactionRequest\x12\x10\n\x08revision\x18\x01 \x01(\x03\x12\x10\n\x08physical\x18\x02 \x01(\x08">\n\x12CompactionResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader",\n\x11LeaseGrantRequest\x12\x0b\n\x03TTL\x18\x01 \x01(\x03\x12\n\n\x02ID\x18\x02 \x01(\x03"f\n\x12LeaseGrantResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\x12\r\n\x05error\x18\x04 \x01(\t" \n\x12LeaseRevokeRequest\x12\n\n\x02ID\x18\x01 \x01(\x03"?\n\x13LeaseRevokeResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader"#\n\x15LeaseKeepAliveRequest\x12\n\n\x02ID\x18\x01 \x01(\x03"[\n\x16LeaseKeepAliveResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03"o\n\x12WatchCreateRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x16\n\x0estart_revision\x18\x03 \x01(\x03\x12\x0f\n\x07prev_kv\x18\x06 \x01(\x08\x12\x10\n\x08watch_id\x18\x07 \x01(\x03"&\n\x12WatchCancelRequest\x12\x10\n\x08watch_id\x18\x01 \x01(\x03"\x8f\x01\n\x0cWatchRequest\x126\n\x0ecreate_request\x18\x01 \x01(\x0b2\x1c.etcdwire.WatchCreateRequestH\x00\x126\n\x0ecancel_request\x18\x02 \x01(\x0b2\x1c.etcdwire.WatchCancelRequestH\x00B\x0f\n\rrequest_union"\xc0\x01\n\rWatchResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x10\n\x08watch_id\x18\x02 \x01(\x03\x12\x0f\n\x07created\x18\x03 \x01(\x08\x12\x10\n\x08canceled\x18\x04 \x01(\x08\x12\x18\n\x10compact_revision\x18\x05 \x01(\x03\x12\x15\n\rcancel_reason\x18\x06 \x01(\t\x12\x1f\n\x06events\x18\x0b \x03(\x0b2\x0f.etcdwire.Event"H\n\x06Member\x12\n\n\x02ID\x18\x01 \x01(\x04\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x10\n\x08peerURLs\x18\x03 \x03(\t\x12\x12\n\nclientURLs\x18\x04 \x03(\t")\n\x11MemberListRequest\x12\x14\n\x0clinearizable\x18\x01 \x01(\x08"a\n\x12MemberListResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12!\n\x07members\x18\x02 \x03(\x0b2\x10.etcdwire.Member"!\n\x13MemberRemoveRequest\x12\n\n\x02ID\x18\x01 \x01(\x04"c\n\x14MemberRemoveResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12!\n\x07members\x18\x02 \x03(\x0b2\x10.etcdwire.Member"\x0f\n\rStatusRequest"\x90\x01\n\x0eStatusResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x0e\n\x06dbSize\x18\x03 \x01(\x03\x12\x0e\n\x06leader\x18\x04 \x01(\x04\x12\x11\n\traftIndex\x18\x05 \x01(\x04\x12\x10\n\x08raftTerm\x18\x06 \x01(\x04"\x13\n\x11DefragmentRequest">\n\x12DefragmentResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader"*\n\x0bLockRequest\x12\x0c\n\x04name\x18\x01 \x01(\x0c\x12\r\n\x05lease\x18\x02 \x01(\x03"E\n\x0cLockResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12\x0b\n\x03key\x18\x02 \x01(\x0c"\x1c\n\rUnlockRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c":\n\x0eUnlockResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader"7\n\x10MemberAddRequest\x12\x10\n\x08peerURLs\x18\x01 \x03(\t\x12\x11\n\tisLearner\x18\x02 \x01(\x08"\x82\x01\n\x11MemberAddResponse\x12(\n\x06header\x18\x01 \x01(\x0b2\x18.etcdwire.ResponseHeader\x12 \n\x06member\x18\x02 \x01(\x0b2\x10.etcdwire.Member\x12!\n\x07members\x18\x03 \x03(\x0b2\x10.etcdwire.Memberb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'etcd_rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _KEYVALUE._serialized_start=28
  _KEYVALUE._serialized_end=145
  _EVENT._serialized_start=148
  _EVENT._serialized_end=299
  _EVENT_EVENTTYPE._serialized_start=267
  _EVENT_EVENTTYPE._serialized_end=299
  _RESPONSEHEADER._serialized_start=301
  _RESPONSEHEADER._serialized_end=393
  _RANGEREQUEST._serialized_start=395
  _RANGEREQUEST._serialized_end=516
  _RANGERESPONSE._serialized_start=518
  _RANGERESPONSE._serialized_end=637
  _PUTREQUEST._serialized_start=639
  _PUTREQUEST._serialized_end=711
  _PUTRESPONSE._serialized_start=713
  _PUTRESPONSE._serialized_end=805
  _DELETERANGEREQUEST._serialized_start=807
  _DELETERANGEREQUEST._serialized_end=876
  _DELETERANGERESPONSE._serialized_start=878
  _DELETERANGERESPONSE._serialized_end=996
  _REQUESTOP._serialized_start=999
  _REQUESTOP._serialized_end=1177
  _RESPONSEOP._serialized_start=1180
  _RESPONSEOP._serialized_end=1366
  _COMPARE._serialized_start=1369
  _COMPARE._serialized_end=1748
  _COMPARE_COMPARERESULT._serialized_start=1595
  _COMPARE_COMPARERESULT._serialized_end=1659
  _COMPARE_COMPARETARGET._serialized_start=1661
  _COMPARE_COMPARETARGET._serialized_end=1732
  _TXNREQUEST._serialized_start=1750
  _TXNREQUEST._serialized_end=1874
  _TXNRESPONSE._serialized_start=1876
  _TXNRESPONSE._serialized_end=1991
  _COMPACTIONREQUEST._serialized_start=1993
  _COMPACTIONREQUEST._serialized_end=2048
  _COMPACTIONRESPONSE._serialized_start=2050
  _COMPACTIONRESPONSE._serialized_end=2112
  _LEASEGRANTREQUEST._serialized_start=2114
  _LEASEGRANTREQUEST._serialized_end=2158
  _LEASEGRANTRESPONSE._serialized_start=2160
  _LEASEGRANTRESPONSE._serialized_end=2262
  _LEASEREVOKEREQUEST._serialized_start=2264
  _LEASEREVOKEREQUEST._serialized_end=2296
  _LEASEREVOKERESPONSE._serialized_start=2298
  _LEASEREVOKERESPONSE._serialized_end=2361
  _LEASEKEEPALIVEREQUEST._serialized_start=2363
  _LEASEKEEPALIVEREQUEST._serialized_end=2398
  _LEASEKEEPALIVERESPONSE._serialized_start=2400
  _LEASEKEEPALIVERESPONSE._serialized_end=2491
  _WATCHCREATEREQUEST._serialized_start=2493
  _WATCHCREATEREQUEST._serialized_end=2604
  _WATCHCANCELREQUEST._serialized_start=2606
  _WATCHCANCELREQUEST._serialized_end=2644
  _WATCHREQUEST._serialized_start=2647
  _WATCHREQUEST._serialized_end=2790
  _WATCHRESPONSE._serialized_start=2793
  _WATCHRESPONSE._serialized_end=2985
  _MEMBER._serialized_start=2987
  _MEMBER._serialized_end=3059
  _MEMBERLISTREQUEST._serialized_start=3061
  _MEMBERLISTREQUEST._serialized_end=3102
  _MEMBERLISTRESPONSE._serialized_start=3104
  _MEMBERLISTRESPONSE._serialized_end=3201
  _MEMBERREMOVEREQUEST._serialized_start=3203
  _MEMBERREMOVEREQUEST._serialized_end=3236
  _MEMBERREMOVERESPONSE._serialized_start=3238
  _MEMBERREMOVERESPONSE._serialized_end=3337
  _STATUSREQUEST._serialized_start=3339
  _STATUSREQUEST._serialized_end=3354
  _STATUSRESPONSE._serialized_start=3357
  _STATUSRESPONSE._serialized_end=3501
  _DEFRAGMENTREQUEST._serialized_start=3503
  _DEFRAGMENTREQUEST._serialized_end=3522
  _DEFRAGMENTRESPONSE._serialized_start=3524
  _DEFRAGMENTRESPONSE._serialized_end=3586
  _LOCKREQUEST._serialized_start=3588
  _LOCKREQUEST._serialized_end=3630
  _LOCKRESPONSE._serialized_start=3632
  _LOCKRESPONSE._serialized_end=3701
  _UNLOCKREQUEST._serialized_start=3703
  _UNLOCKREQUEST._serialized_end=3731
  _UNLOCKRESPONSE._serialized_start=3733
  _UNLOCKRESPONSE._serialized_end=3791
  _MEMBERADDREQUEST._serialized_start=3793
  _MEMBERADDREQUEST._serialized_end=3848
  _MEMBERADDRESPONSE._serialized_start=3851
  _MEMBERADDRESPONSE._serialized_end=3981
# @@protoc_insertion_point(module_scope)

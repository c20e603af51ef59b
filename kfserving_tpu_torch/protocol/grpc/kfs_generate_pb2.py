# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: kfs_generate.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12kfs_generate.proto\x12\x12kfserving.generate\"\x95\x02\n\x0fGenerateRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x12\n\ntext_input\x18\x02 \x01(\t\x12\x17\n\nmax_tokens\x18\x03 \x01(\rH\x00\x88\x01\x01\x12\x18\n\x0btemperature\x18\x04 \x01(\x02H\x01\x88\x01\x01\x12\x12\n\x05top_k\x18\x05 \x01(\rH\x02\x88\x01\x01\x12\x12\n\x05top_p\x18\x06 \x01(\x02H\x03\x88\x01\x01\x12\x11\n\x04seed\x18\x07 \x01(\x04H\x04\x88\x01\x01\x12\x0c\n\x04stop\x18\x08 \x03(\t\x12\x15\n\x08logprobs\x18\t \x01(\rH\x05\x88\x01\x01\x42\r\n\x0b_max_tokensB\x0e\n\x0c_temperatureB\x08\n\x06_top_kB\x08\n\x06_top_pB\x07\n\x05_seedB\x0b\n\t_logprobs\"+\n\x0cTokenLogprob\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0f\n\x07logprob\x18\x02 \x01(\x02\"{\n\x05Token\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04text\x18\x02 \x01(\t\x12\x14\n\x07logprob\x18\x03 \x01(\x02H\x00\x88\x01\x01\x12\x36\n\x0ctop_logprobs\x18\x04 \x03(\x0b\x32 .kfserving.generate.TokenLogprobB\n\n\x08_logprob\"\x95\x01\n\x16GenerateStreamResponse\x12-\n\x05token\x18\x01 \x01(\x0b\x32\x19.kfserving.generate.TokenH\x00\x88\x01\x01\x12\x15\n\rfinish_reason\x18\x02 \x01(\t\x12\x16\n\x0egenerated_text\x18\x03 \x01(\t\x12\x13\n\x0btoken_count\x18\x04 \x01(\rB\x08\n\x06_token\"\xcd\x01\n\x10GenerateResponse\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x13\n\x0btext_output\x18\x02 \x01(\t\x12\x15\n\rfinish_reason\x18\x03 \x01(\t\x12\x13\n\x0btoken_count\x18\x04 \x01(\r\x12\x39\n\x0f\x63hosen_logprobs\x18\x05 \x03(\x0b\x32 .kfserving.generate.TokenLogprob\x12)\n\x06tokens\x18\x06 \x03(\x0b\x32\x19.kfserving.generate.Token2\xd3\x01\n\x11GenerationService\x12W\n\x08Generate\x12#.kfserving.generate.GenerateRequest\x1a$.kfserving.generate.GenerateResponse\"\x00\x12\x65\n\x0eGenerateStream\x12#.kfserving.generate.GenerateRequest\x1a*.kfserving.generate.GenerateStreamResponse\"\x00\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'kfs_generate_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GENERATEREQUEST._serialized_start=43
  _GENERATEREQUEST._serialized_end=320
  _TOKENLOGPROB._serialized_start=322
  _TOKENLOGPROB._serialized_end=365
  _TOKEN._serialized_start=367
  _TOKEN._serialized_end=490
  _GENERATESTREAMRESPONSE._serialized_start=493
  _GENERATESTREAMRESPONSE._serialized_end=642
  _GENERATERESPONSE._serialized_start=645
  _GENERATERESPONSE._serialized_end=850
  _GENERATIONSERVICE._serialized_start=853
  _GENERATIONSERVICE._serialized_end=1064
# @@protoc_insertion_point(module_scope)

"""Sharded retrieval: a row-partitioned vector DB over ``TorchVectorDB``
shards that sits behind the component registry like any other ``vectordb``
backend (``torch_sharded``)."""
from repro_torch.sharded.vectordb import (ShardedDBConfig, ShardedVectorDB,
                                          doc_shard, make_sharded_db)

__all__ = ["ShardedDBConfig", "ShardedVectorDB", "doc_shard",
           "make_sharded_db"]

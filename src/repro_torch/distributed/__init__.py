"""Distribution over ``torch.distributed`` process groups: the logical-axis
sharding rules (:mod:`.sharding`), the train / prefill / serve steps with
the AllReduce (DDP) or ScatterReduce (FSDP) pattern (:mod:`.step`), and
local SGD / DiLoCo across pods (:mod:`.local_sgd`)."""

"""Sharding (:mod:`.sharding`): the logical-axis rules that lay tensors
out on a ``DeviceMesh``, and the trace policies that split a trace over the
fleet; and the fault-tolerance state machines the service drives
(:mod:`.fault_tolerance`)."""

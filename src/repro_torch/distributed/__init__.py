"""Trace sharding for the fleet (:mod:`.sharding`) and the fault-tolerance
state machines the service drives (:mod:`.fault_tolerance`)."""

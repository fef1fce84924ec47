"""The comms layer's host-side pieces that serving uses: the retry
policy (:mod:`~raft_tpu_torch.comms.resilience`) and the fault
vocabulary (:mod:`~raft_tpu_torch.comms.faults`).  The communicator
itself waits for the multi-GPU slice."""

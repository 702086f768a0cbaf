"""Runtime: ServeConfig and the slot-batched DecodeServer, the training
loop, the straggler monitor and the int8 block codec."""

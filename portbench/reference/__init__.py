"""The plain reference of the tracker: networks, operations, tracker and
step, in float32 PyTorch with no kernel of the port."""

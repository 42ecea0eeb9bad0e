"""RAFT, the recurrent flow completion net and the inpainting generator as
`nn.Module`s whose `state_dict()` keys are the released checkpoints' keys."""

"""BlockLLM itself: selectable units, the selection policy and the
masked-Adam train step over the active subset."""

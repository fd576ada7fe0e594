"""The benchmark's plain reference (:mod:`.model`): plain PyTorch, no
program code, run in float64 to judge the program and in bfloat16 as the
control that the comparison has to fail."""

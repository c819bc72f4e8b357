"""Each test process runs the program's CPU route on two threads, so
that test workers side by side do not oversubscribe the host."""

import torch

torch.set_num_threads(min(2, torch.get_num_threads()))

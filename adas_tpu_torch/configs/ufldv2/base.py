# Shared UFLDv2 training defaults (SGD schedule per the reference configs,
# exportLib/ultrafastLaneV2/configs/*.py); dataset geometry lives in the
# per-dataset files inheriting from this one via `_base_`.
optimizer = "SGD"
learning_rate = 0.05
weight_decay = 1e-4
momentum = 0.9
scheduler = "multi"
gamma = 0.1
warmup = "linear"
batch_size = 32
use_aux = False
num_lanes = 4
var_loss_power = 2.0
mean_loss_w = 0.05
tta = True
mesh = dict(data=-1, model=1)  # -1: all remaining devices on the data axis

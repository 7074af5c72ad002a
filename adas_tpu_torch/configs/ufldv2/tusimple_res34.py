_base_ = "./tusimple_res18.py"
backbone = "34"

_base_ = "./curvelanes_res18.py"
backbone = "34"

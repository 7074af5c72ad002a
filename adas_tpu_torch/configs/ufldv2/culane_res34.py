_base_ = "./culane_res18.py"
backbone = "34"

"""The benchmark's plain fp32 reference: the models, the objective, AdamW and
the ranking, written from the published descriptions in plain PyTorch. It
imports nothing of the program under test."""

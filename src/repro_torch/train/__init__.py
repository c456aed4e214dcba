"""Training: AdamW (:mod:`.optimizer`), the train step
(:mod:`.train_step`) and gradient compression (:mod:`.grad_compress`)."""

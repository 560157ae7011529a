"""Single-device training: optimizer, schedules, microbatches, the train
step and the ``pretrain`` driver."""

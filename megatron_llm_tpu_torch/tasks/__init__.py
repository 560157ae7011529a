"""Downstream tasks (reference: tasks/): GLUE / RACE finetuning of a BERT
and ORQA retrieval evaluation."""

from rag_serving_system.training.contrastive import (
    contrastive_loss,
    make_train_step,
    train_encoder,
)

from prime_rl_tpu_torch.transport.types import MicroBatch, TrainingBatch, TrainingSample, decode, encode


def setup_training_batch_sender(config, output_dir):
    from prime_rl_tpu_torch.configs.trainer import ZMQTransportConfig

    if isinstance(config, ZMQTransportConfig):
        from prime_rl_tpu_torch.transport.zmq import ZMQTrainingBatchSender

        return ZMQTrainingBatchSender(config.host, config.batch_port)
    from prime_rl_tpu_torch.transport.filesystem import FSTrainingBatchSender

    return FSTrainingBatchSender(output_dir)


def setup_training_batch_receiver(config, output_dir, start_step: int = 0):
    from prime_rl_tpu_torch.configs.trainer import ZMQTransportConfig

    if isinstance(config, ZMQTransportConfig):
        from prime_rl_tpu_torch.transport.zmq import ZMQTrainingBatchReceiver

        return ZMQTrainingBatchReceiver(config.host, config.batch_port)
    from prime_rl_tpu_torch.transport.filesystem import FSTrainingBatchReceiver

    return FSTrainingBatchReceiver(output_dir, start_step)


def setup_micro_batch_sender(config, output_dir, num_ranks: int):
    from prime_rl_tpu_torch.configs.trainer import ZMQTransportConfig

    if isinstance(config, ZMQTransportConfig):
        from prime_rl_tpu_torch.transport.zmq import ZMQMicroBatchSender

        return ZMQMicroBatchSender(config.host, config.micro_batch_port, num_ranks)
    from prime_rl_tpu_torch.transport.filesystem import FSMicroBatchSender

    return FSMicroBatchSender(output_dir)


def setup_micro_batch_receiver(config, output_dir, rank: int, start_step: int = 0):
    from prime_rl_tpu_torch.configs.trainer import ZMQTransportConfig

    if isinstance(config, ZMQTransportConfig):
        from prime_rl_tpu_torch.transport.zmq import ZMQMicroBatchReceiver

        return ZMQMicroBatchReceiver(config.host, config.micro_batch_port, rank)
    from prime_rl_tpu_torch.transport.filesystem import FSMicroBatchReceiver

    return FSMicroBatchReceiver(output_dir, rank, start_step)

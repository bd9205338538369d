"""The streaming-mIoU evaluator."""

from otedama_tpu_torch.p2p.messages import MessageType, P2PMessage
from otedama_tpu_torch.p2p.node import NodeConfig, P2PNode

__all__ = ["MessageType", "P2PMessage", "P2PNode", "NodeConfig"]

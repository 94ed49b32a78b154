from repro_torch.infserver.server import InfServer, Ticket
